"""PyTorch/CUDA port of the single-view render-and-compare fit.

Mirrors the module names of ``soccerplayershapepose_tpu`` so each counterpart
is easy to find. The banded soft-silhouette forward and backward run as
hand-written CUDA kernels (``csrc/band_raster.cu``) on CUDA tensors; CPU
tensors take the plain PyTorch versions beside them.
"""
