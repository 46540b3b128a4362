"""PyTorch/CUDA port of the parallel iterated Kalman smoothers.

A second package beside the JAX reference ``repro``: it imports torch and
nothing of JAX or of ``repro``. Its entry points run on the card (``cuda``)
unless the caller passes ``device="cpu"``; the batched Kalman combines
(paper Eq. 15 and Eq. 19) run as hand-written Hopper kernels
(``csrc/kalman_combine.cu``) built with ``nvcc`` at first use.
"""
