"""Packing, fingerprints, dedup, the hash set and the CUDA kernels."""
