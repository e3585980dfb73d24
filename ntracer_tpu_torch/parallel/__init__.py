"""Rendering over several devices (``mesh``): pixels split over the px
axis, the triangle pool over the prim axis."""
