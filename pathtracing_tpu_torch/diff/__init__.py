"""Differentiable rendering (diff/render.py): fixed-topology gradients of a
loss of the rendered radiance with respect to the scene's tables."""
