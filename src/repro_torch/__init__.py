"""PyTorch/CUDA port of the parallel iterated Kalman smoothers.

A second package beside the JAX reference ``repro``: it imports torch and
nothing of JAX or of ``repro``. Its entry points run on the card (``cuda``)
unless the caller passes ``device="cpu"``. Every Pallas TPU kernel of the
JAX package has a hand-written Hopper counterpart, built with ``nvcc`` at
first use: the batched Kalman combines (paper Eq. 15 and Eq. 19,
``csrc/kalman_combine.cu``) on the smoother's path, the linear-recurrence
scan (``csrc/ssm_scan.cu``) behind ``core.linear_recurrence_scan``, and
causal GQA flash attention (``csrc/flash_attention.cu``) behind
``kernels.flash_attention.ops.flash_attention``. On CPU tensors each
kernel wrapper runs its plain PyTorch version.
"""
