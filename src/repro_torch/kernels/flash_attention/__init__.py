"""Blocked causal GQA attention with an online softmax as a CUDA kernel."""
