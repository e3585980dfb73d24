"""Integer channels wider than 23 bits: the port's exact host packer
(``packing.pack_rows`` / ``pack_flat``) against the JAX package's, and
whole frames of such a format through both of the port's renderers."""

import threading

import numpy as np
import pytest

from ntracer_tpu.engine import packing as jpack
from ntracer_tpu.render import BlockingRenderer as JaxRenderer
from ntracer_tpu_torch import (BlockingRenderer, CallbackRenderer,
                               ImageFormat, Channel)
from ntracer_tpu_torch.engine import packing as ppack
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import JAX, PORT, api, random_scene

# the frames' colors agree with the JAX package's to rtol 2e-6 / atol 2e-7
# (XLA contracts a*b+c on the CPU); in codes of a b-bit channel that is
# (2e-6 * |color| + 2e-7) * (2^b - 1), about 2,150 codes of a 30-bit
# channel at color 1, plus one for the rounding to a code
RTOL, ATOL = 2e-6, 2e-7


def _formats(pkg):
    a = api(pkg)
    Ch = a.Channel
    return {
        "24_8": a.ImageFormat(16, 16, [Ch(24, 1, 0, 0), Ch(8, 0, 1, 0)]),
        "30_30_4": a.ImageFormat(16, 16, [Ch(30, 1, 0, 0), Ch(30, 0, 1, 0),
                                          Ch(4, 0, 0, 1)]),
        "31_float_reversed": a.ImageFormat(
            16, 16, [Ch(31, 0.5, 0.25, 0.25, 0.1),
                     Ch(32, 0, 1, 0, tfloat=True), Ch(26, 0, 0, 1),
                     Ch(7, 1, 1, 1)], reversed=True),
        "float_32": a.ImageFormat(16, 16, [Ch(32, 1, 0, 0, tfloat=True),
                                           Ch(32, 0, 0, 1, tfloat=True)]),
        "odd_widths": a.ImageFormat(16, 16, [Ch(3, 1, 0, 0), Ch(29, 0, 1, 0),
                                             Ch(30, 0, 0, 1), Ch(1, 1, 1, 0)],
                                    pitch=16 * 8 + 5),
    }


def _colors(seed=0):
    """Random colors (some outside [0, 1]) plus 0, 1 and values at the
    rounding boundary of a code: (16, 16, 3) float32."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.2, 1.2, (256, 3)).astype(np.float32)
    c[0], c[1] = 0.0, 1.0
    k = rng.randint(0, 1 << 20, 60)
    for row, b in enumerate((24, 26, 29, 30, 31)):
        half = ((k + 0.5) / float((1 << b) - 1)).astype(np.float32)
        c[2 + 12 * row:14 + 12 * row] = half[12 * row:12 * row + 12, None]
    c[62:70] = np.nextafter(np.float32(1), np.float32(0))
    return c.reshape(16, 16, 3)


@pytest.mark.parametrize("name", sorted(_formats(PORT)))
def test_host_packer_equals_jax(name):
    """pack_rows and pack_flat equal the JAX package's byte for byte."""
    fmt, jfmt = _formats(PORT)[name], _formats(JAX)[name]
    for seed in (0, 1):
        colors = _colors(seed)
        got = ppack.pack_rows(colors, fmt)
        ref = jpack.pack_rows(colors, jfmt)
        assert got.dtype == np.uint8
        assert got.shape == (16, 16 * fmt.bytes_per_pixel)
        assert np.array_equal(got, ref)
        flat = colors.reshape(-1, 3)
        assert np.array_equal(ppack.pack_flat(flat, fmt),
                              jpack.pack_flat(flat, jfmt))
        assert np.array_equal(ppack.pack_flat(flat, fmt).reshape(16, -1),
                              got)


def test_host_packer_rounds_half_codes_up():
    """A value v with v * (2^b - 1) exactly k + 0.5 rounds away from zero
    (lround): at b = 31, 1/2 gives code 2^30."""
    fmt = ImageFormat(1, 1, [Channel(31, 1, 0, 0), Channel(1, 0, 0, 0)])
    out = ppack.pack_rows(np.array([[[0.5, 0, 0]]], np.float32), fmt)
    assert int.from_bytes(out.tobytes(), "big") >> 1 == 1 << 30


def _codes(buf, fmt, h, w):
    """The three channel codes of a 30/30/4 frame."""
    rows = np.frombuffer(bytes(buf), np.uint8).reshape(h, fmt.pitch)
    v = rows[:, :w * 8].copy().view(">u8").reshape(h, w).astype(np.uint64)
    return [(v >> np.uint64(34)).astype(np.int64),
            ((v >> np.uint64(4)) & np.uint64((1 << 30) - 1)).astype(np.int64),
            (v & np.uint64(15)).astype(np.int64)]


def test_wide_frame_through_both_renderers():
    """A 24x24 30/30/4 frame (rows padded by 3 bytes) through the blocking
    and the callback renderer equals pack_rows of the port's float colors
    exactly, and its codes agree with the JAX package's frame within the
    colors' tolerance."""
    w = h = 24
    scene = random_scene(3, n=60, seed=31)
    a = api(PORT)
    fmt = a.ImageFormat(w, h, [a.Channel(30, 1, 0, 0), a.Channel(30, 0, 1, 0),
                               a.Channel(4, 0, 0, 1)], pitch=w * 8 + 3)
    assert pwf._needs_host_pack(fmt)
    colors = pwf.frame_colors(scene, w, h, "cpu")
    expect = ppack.pack_rows(colors, fmt)

    buf = bytearray(fmt.pitch * h)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    rows = np.frombuffer(bytes(buf), np.uint8).reshape(h, fmt.pitch)
    assert np.array_equal(rows[:, :w * 8], expect)
    assert not rows[:, w * 8:].any()

    buf2 = bytearray(fmt.pitch * h)
    done = threading.Event()
    CallbackRenderer(device="cpu").begin_render(buf2, fmt, scene,
                                                lambda r: done.set())
    assert done.wait(timeout=120)
    assert buf2 == buf

    ja = api(JAX)
    jfmt = ja.ImageFormat(w, h, [ja.Channel(30, 1, 0, 0),
                                 ja.Channel(30, 0, 1, 0),
                                 ja.Channel(4, 0, 0, 1)], pitch=w * 8 + 3)
    jscene = random_scene(3, n=60, seed=31, pkg=JAX)
    jbuf = bytearray(jfmt.pitch * h)
    assert JaxRenderer().render(jbuf, jfmt, jscene)
    got, ref = _codes(buf, fmt, h, w), _codes(jbuf, jfmt, h, w)
    for c, (g, r) in enumerate(zip(got, ref)):
        bits = (30, 30, 4)[c]
        value = r / float((1 << bits) - 1)
        bound = (RTOL * value + ATOL) * ((1 << bits) - 1) + 1
        assert (np.abs(g - r) <= bound).all(), c
    assert (got[0] == ref[0]).mean() > 0.5


def test_wide_format_keeps_float_colors_off_the_device_packer(monkeypatch):
    """A wide format dispatches float colors and never reaches the device
    packer (whose float32 rounding it exceeds); an 8-bit one packs on the
    device."""
    scene = random_scene(3, n=20, seed=3)
    fmt = _formats(PORT)["24_8"]
    calls = []
    real = ppack.pack_device_stream
    monkeypatch.setattr(ppack, "pack_device_stream",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    slabs = pwf.dispatch_packed(scene, fmt, "cpu")
    assert not calls and all(dev.dtype.is_floating_point and dev.shape[1] == 3
                             for _s, dev, _r in slabs)
    with pytest.raises(ValueError, match="23"):
        ppack._pack_words(slabs[0][1].T, ppack.format_key(fmt))
    slabs = pwf.dispatch_packed(scene, api(PORT).ImageFormat(
        16, 16, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                 Channel(8, 0, 0, 1)]), "cpu")
    assert calls == [1] and slabs[0][1].dtype.is_floating_point is False
