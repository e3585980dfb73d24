"""Pygame-backed CallbackRenderer (reference lib/ntracer/pygame_render.py),
the port's copy of ``ntracer_tpu/pygame_render.py``.

pygame is optional: without it this module imports, and only
``PygameRenderer`` raises ImportError when it is made.
"""

from .render import Channel, ImageFormat, CallbackRenderer

try:
    import pygame
    HAVE_PYGAME = True
except ImportError:
    pygame = None
    HAVE_PYGAME = False

ON_COMPLETE = None if pygame is None else (pygame.USEREVENT + 1)


def channels_from_surface(surface):
    """Derive the Channel list from a pygame surface's masks/shifts/losses
    (reference pygame_render.py:8-46)."""
    masks = surface.get_masks()
    losses = surface.get_losses()
    shifts = surface.get_shifts()
    bytes_per_pixel = surface.get_bytesize()

    # channel entries ordered from the high bits down
    entries = []
    for i, mask in enumerate(masks):
        if not mask:
            continue
        size = 8 - losses[i]
        coeff = [0.0, 0.0, 0.0]
        if i < 3:
            coeff[i] = 1.0
        entries.append((shifts[i], size, coeff))
    entries.sort(key=lambda e: -e[0])

    channels = []
    used = 0
    for shift, size, coeff in entries:
        total_above = bytes_per_pixel * 8 - (shift + size)
        if total_above > used:
            channels.append(Channel(total_above - used, 0, 0, 0))
            used = total_above
        channels.append(Channel(size, *coeff))
        used += size
    if used < bytes_per_pixel * 8:
        channels.append(Channel(bytes_per_pixel * 8 - used, 0, 0, 0))

    return channels


class PygameRenderer(CallbackRenderer):
    """CallbackRenderer that draws into a pygame Surface and posts an
    ON_COMPLETE event from the worker's callback
    (reference pygame_render.py:51-127)."""

    def __init__(self, threads=0, device="cuda"):
        if not HAVE_PYGAME:
            raise ImportError("pygame is required for PygameRenderer")
        super().__init__(threads, device)
        pygame.register_quit(self._on_quit)

    def _on_quit(self):
        self.abort_render()

    def begin_render(self, surface, scene):
        fmt = ImageFormat(
            surface.get_width(),
            surface.get_height(),
            channels_from_surface(surface),
            surface.get_pitch())

        def callback(renderer):
            pygame.event.post(pygame.event.Event(ON_COMPLETE, renderer=renderer,
                                                 surface=surface))

        buffer = surface.get_buffer()
        super().begin_render(buffer, fmt, scene, callback)
