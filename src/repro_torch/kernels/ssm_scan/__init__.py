"""Diagonal linear-recurrence scan ``h_t = a_t h_{t-1} + b_t`` as a CUDA
kernel."""
