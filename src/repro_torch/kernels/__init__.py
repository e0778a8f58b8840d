"""The hand-written Hopper kernels (``repro_torch/csrc``), their plain
PyTorch versions, their build and binding (``build``) and the public
wrappers (``ops``)."""
