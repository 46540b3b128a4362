"""Batched Kalman combines (paper Eq. 15 / Eq. 19) as CUDA kernels."""
