"""The int8 and bf16acc format policies through the port's model entry
points against the JAX package's (see test_torch_model.py for the
harness; a file of its own so the two run on separate test workers)."""
import numpy as np
import pytest

from torch_parity import MODEL_TOL, n, run_model_pair


@pytest.mark.parametrize("fmt", ["int8", "bf16acc"])
def test_quantized_and_narrow_accumulator_formats_match_jax(fmt):
    """int8 (quantize → int32 accumulate → dequantize) and bf16acc (bf16
    running sum) through the whole model.  Looser tolerances: an int8
    rounding tie or a bf16 accumulator rounding can land one step apart
    when the two packages' activations differ in the last f32 bit, and
    bf16acc's result depends on the plan's K block (the port plans its
    own; the kernel-level test pins the JAX plan's)."""
    pairs, _, _ = run_model_pair(fmt, None, n_decode=2)
    tol = MODEL_TOL[fmt]
    for i, (tl, jl) in enumerate(pairs):
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"call {i}")
