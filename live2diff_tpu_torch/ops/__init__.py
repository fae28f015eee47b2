"""Attention, convolution and normalisation ops, with their CUDA kernels."""
