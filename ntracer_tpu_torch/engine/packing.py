"""Channel bit-packing: float RGB -> packed pixel bytes.

The PyTorch counterpart of ``ntracer_tpu/engine/packing.py``
(``format_key``, ``_pack_words``, ``pack_device_stream`` on the device;
``pack_rows`` / ``pack_flat`` on the host), itself a port of
``process_pixel`` (render.cpp:396-466): per channel,
``clamp(f_r*r + f_g*g + f_b*b + f_c, 0, 1)`` is scaled to ``bit_size`` bits
(``lround``, half away from zero) or bit-cast when ``tfloat``, then channels
pack MSB-first into ``bytes_per_pixel`` bytes; ``reversed`` flips the byte
order.

The device packer rounds in float32 and is exact for integer channels of
up to 23 bits; a format with a wider one takes the host packer, which
keeps the reference's 64-bit math and is exact for every width.

torch implements few bitwise ops for uint32, so the word math runs in int64
and the stream narrows to int32 at the end (same bits).  The ops run
eagerly, one rounding each, which keeps the Fast2Sum below exact.
"""

from __future__ import annotations

import numpy as np
import torch


def format_key(fmt):
    """Hashable description of the pixel format."""
    return (tuple((c.bit_size, c.f_r, c.f_g, c.f_b, c.f_c, c.tfloat)
                  for c in fmt.channels),
            fmt.bytes_per_pixel, bool(fmt.reversed))


def _f32(x):
    return float(np.float32(x))


def _pack_words(colorsT, key):
    """(3, R) float32 -> list of (R,) int64 words, each holding 32 bits of a
    pixel's packed channels MSB-first."""
    channels, bpp, _reverse = key
    r, g, b = colorsT[0], colorsT[1], colorsT[2]
    n = colorsT.shape[1]
    n_words = (bpp + 3) // 4
    words = [torch.zeros(n, dtype=torch.int64, device=colorsT.device)
             for _ in range(n_words)]

    off = 0
    for bit_size, f_r, f_g, f_b, f_c, tfloat in channels:
        val = torch.clamp(r * _f32(f_r) + g * _f32(f_g) + b * _f32(f_b)
                          + _f32(f_c), 0.0, 1.0)
        if tfloat:
            ival = val.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        elif bit_size > 23:
            # the frame routes such formats to pack_rows
            # (wavefront._needs_host_pack)
            raise ValueError(
                "the device packer takes integer channels of at most 23 "
                "bits; wider ones take the exact host packer (pack_rows)")
        else:
            # exact lround(double(val) * (2^b - 1)): val * 2^b is exact, so
            # p = fl(val*2^b - val) == fl(val * scale) and the subtraction's
            # error is recovered exactly by a Fast2Sum (val*2^b >= val >= 0);
            # q = p + 0.5 and its floor are exact because p < 2^23.
            p_hi = val * float(1 << bit_size)
            p = p_hi - val
            err = (p_hi - p) - val
            q = p + 0.5
            i0 = torch.floor(q)
            frac = (q - i0) + err
            i0 = i0 + (frac >= 1).to(torch.float32) \
                - (frac < 0).to(torch.float32)
            ival = i0.to(torch.int64)
        o = off // 32
        rm = off % 32
        s = 32 - rm - bit_size
        if s >= 0:
            words[o] = words[o] | (ival << s)
        else:
            words[o] = words[o] | (ival >> -s)
        if rm + bit_size > 32:
            words[o + 1] = words[o + 1] | \
                ((ival << (64 - rm - bit_size)) & 0xFFFFFFFF)
        off += bit_size
    return words


def _to_int32(w):
    """int64 holding 32-bit words -> int32 with the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_device_stream(colorsT, key, permute=None):
    """(3, R) float32 -> (R//4, bpp) int32 stream whose little-endian bytes
    are the frame's packed pixels, 4 pixels per row of bpp words.  Requires
    R % 4 == 0.

    ``permute`` (optional) reorders pixels between the per-pixel word pack
    and the 4-pixel grouping (the tile unswizzle): it receives an (R,)
    tensor and returns it permuted."""
    _channels, bpp, reverse = key
    R = colorsT.shape[1]
    if R % 4:
        raise ValueError("pack_device_stream needs a multiple of 4 pixels")
    words = _pack_words(colorsT, key)
    if permute is not None:
        words = [permute(w) for w in words]
    wr = [w.reshape(-1, 4) for w in words]  # (R//4, 4 px per group)
    byte_order = list(range(bpp - 1, -1, -1) if reverse else range(bpp))
    out = []
    for w_idx in range(bpp):            # output word within the group
        acc = torch.zeros(R // 4, dtype=torch.int64, device=colorsT.device)
        for k in range(4):              # little-endian byte k of the word
            i = 4 * w_idx + k           # byte index within the group
            p, jj = divmod(i, bpp)      # pixel in group, byte in pixel
            j = byte_order[jj]
            byt = (wr[j // 4][:, p] >> (8 * (3 - (j % 4)))) & 0xFF
            acc = acc | (byt << (8 * k))
        out.append(_to_int32(acc))
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Exact host packer (numpy; the reference's 64-bit math)
# ---------------------------------------------------------------------------

def pack_flat(colors, fmt):
    """Host packing of a flat color slab: (N, 3) float32 -> (N, bpp) uint8.

    For formats with integer channels wider than 23 bits: the frame ships
    raw float colors and this packs them with the reference's exact 64-bit
    math."""
    n = colors.shape[0]
    return pack_rows(colors.reshape(1, n, 3), fmt).reshape(
        n, fmt.bytes_per_pixel)


def pack_rows(colors, fmt):
    """Host packing: (rows, W, 3) float32 -> (rows, W*bpp) uint8, exact for
    every channel width (``process_pixel``, render.cpp:396-466)."""
    rows, w, _ = colors.shape
    n = rows * w
    c = np.asarray(colors, dtype=np.float32).reshape(n, 3)
    bpp = fmt.bytes_per_pixel

    temp = np.zeros((n, 2), dtype=np.uint64)
    b_offset = 0
    for ch in fmt.channels:
        val = np.clip(ch.f_r * c[:, 0] + ch.f_g * c[:, 1] + ch.f_b * c[:, 2]
                      + np.float32(ch.f_c), 0.0, 1.0).astype(np.float32)
        if ch.tfloat:
            ival = val.view(np.uint32).astype(np.uint64)
        else:
            scale = np.float64(0xFFFFFFFF >> (32 - ch.bit_size))
            # std::lround: round half away from zero (values here are >= 0)
            ival = np.floor(val.astype(np.float64) * scale + 0.5).astype(
                np.uint64)

        o = b_offset // 64
        rm = b_offset % 64
        s = 64 - rm - ch.bit_size
        if s >= 0:
            temp[:, o] |= ival << np.uint64(s)
        else:
            temp[:, o] |= ival >> np.uint64(-s)
        if rm + ch.bit_size > 64:
            temp[:, o + 1] = ival << np.uint64(128 - rm - ch.bit_size)
        b_offset += ch.bit_size

    # big-endian byte extraction (render.cpp:449-461)
    out = np.empty((n, bpp), dtype=np.uint8)
    byte_order = range(bpp - 1, -1, -1) if fmt.reversed else range(bpp)
    for out_j, j in enumerate(byte_order):
        word = temp[:, j // 8]
        shift = np.uint64((8 - 1 - (j % 8)) * 8)
        out[:, out_j] = (word >> shift).astype(np.uint8)

    return out.reshape(rows, w * bpp)
