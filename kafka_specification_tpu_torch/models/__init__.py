"""Tensor encodings and batched action/invariant kernels."""
