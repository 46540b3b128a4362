"""Oracle for the kalman_combine kernels: the textbook combines of
`repro_torch.core.parallel` (LU solves, exactly the algebra the paper
describes), batched over the leading axis."""
from repro_torch.core.parallel import filtering_combine, smoothing_combine


def filtering_combine_batched_ref(ei, ej):
    return filtering_combine(ei, ej)


def smoothing_combine_batched_ref(ei, ej):
    return smoothing_combine(ei, ej)
