"""MoE routing when router probabilities tie, against the JAX package.

``jax.lax.top_k`` puts the lower index first among equal values; the
port's ``models/moe.py:top_k`` must choose the same experts in the same
order, or a tied token is routed to other experts and its output differs
by the size of the output itself.  The router's columns are made to tie
on purpose: columns repeat in groups, and x and the router hold small
integers and multiples of 1/8, so every logit is exact in bf16 and in
fp32 on both sides and ties survive the rounding of either framework.
Layer tolerances: fp32 as ``tests/test_torch_moe.py`` (rtol/atol 1e-4:
XLA's and ATen's CPU sums add in different orders); bf16 as K3's bf16
tolerance in ``tests/test_kernels.py`` (5e-2: the two frameworks round
silu and the gating at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.sharding import make_rules
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry

RULES = make_rules()
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tied_layer(rng, e, d, f):
    """One MoE layer whose router columns repeat: column j is group
    ``j % 3`` of three base columns, so each group's experts tie on every
    token.  Router entries are multiples of 1/8 in [-1/4, 1/4]; expert
    weights are random normal."""
    base = rng.integers(-2, 3, size=(d, 3)) / 8.0
    router = base[:, np.arange(e) % 3]
    return {"router": router,
            "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
            "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
            "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}


def _tokens(rng, b, s, d):
    """Entries in {-1, 0, 1}: with the router's, every logit is a multiple
    of 1/8 of magnitude at most d / 4 = 8, exact in bf16 (7 bits)."""
    return rng.integers(-1, 2, size=(b, s, d)).astype(np.float64)


@pytest.mark.parametrize("row,k,want", [
    ([1, 3, 3, 3, 0, 3], 2, [1, 2]),
    ([1, 3, 3, 3, 0, 3], 4, [1, 2, 3, 5]),
    ([2, 2, 2, 2], 3, [0, 1, 2]),
    ([0, 5, 1, 5, 5, 1, 2, 0], 5, [1, 3, 4, 6, 2])])
def test_top_k_breaks_ties_to_the_lower_index_like_jax(row, k, want):
    probs = np.asarray([row], np.float32)
    _, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tp, ti = tmoe.top_k(torch.from_numpy(probs), k)
    assert np.asarray(ji).tolist() == [want]
    assert ti.tolist() == [want]
    assert tp.tolist() == [[row[i] for i in want]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_tied_router_chooses_the_reference_experts(arch, dtype):
    """The experts chosen from one set of tied probabilities, and the layer
    output, equal the reference's; most tokens meet a tie at their k-th
    choice."""
    jcfg = jregistry.get_config(arch, reduced=True).replace(dtype=dtype)
    tcfg = tregistry.get_config(arch, reduced=True).replace(dtype=dtype)
    e, d, f, k = (tcfg.n_experts, tcfg.d_model, tcfg.d_ff,
                  tcfg.experts_per_token)
    rng = np.random.default_rng(16)
    layer = _tied_layer(rng, e, d, f)
    x = _tokens(rng, 2, 32, d)

    # the choice itself, from the same fp32 probabilities on both sides
    logits = x.reshape(-1, d) @ layer["router"]
    probs = np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32)))
    _, ji = jax.lax.top_k(jnp.asarray(probs), k)
    _, ti = tmoe.top_k(torch.from_numpy(probs), k)
    assert ti.numpy().tolist() == np.asarray(ji).tolist()
    # the k-th and (k+1)-th choices tie for most tokens (a group of three
    # on top, or two groups level)
    srt = -np.sort(-probs, axis=-1)
    assert (srt[:, k - 1] == srt[:, k]).mean() > 0.5

    jout, jaux = jmoe.apply_moe(
        jcfg, {n: jnp.asarray(v, JDT[dtype]) for n, v in layer.items()},
        jnp.asarray(x, JDT[dtype]), RULES)
    tout, taux = tmoe.apply_moe(
        tcfg, {n: torch.from_numpy(v).to(TDT[dtype])
               for n, v in layer.items()},
        torch.from_numpy(x).to(TDT[dtype]))
    assert tout.dtype == TDT[dtype]
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
