"""Device compute ops: convolution lowerings and matmul precision tiers."""

from .convolve import conv1d_poly, set_conv_impl

__all__ = ["conv1d_poly", "set_conv_impl"]
