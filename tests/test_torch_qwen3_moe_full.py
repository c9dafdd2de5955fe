"""qwen3-moe-30b-a3b at its published width, held against the JAX package
without allocating it: the port's parameter tree has the reference's leaf
shapes and element count, its capacity follows the reference's at the
token counts the serving engine uses, and K3's plain version at the
path's E 128 and admission C 20 (reduced d and f, fp32) matches the
reference's ``moe_ffn`` at K3's fp32 tolerance (3e-4,
``tests/test_kernels.py``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

ARCH = "qwen3-moe-30b-a3b"
BATCH, PREFILL_LEN = 4, 256        # chip_smoke.py phase 26's engine


def _shapes(tree, path=()):
    """{key path: shape} of a tree of leaves with a ``.shape``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes(tree[k], path + (k,)))
        return out
    return {"/".join(path): tuple(tree.shape)}


def test_full_tree_matches_reference_shapes_and_counts():
    tcfg, jcfg = tregistry.get_config(ARCH), jregistry.get_config(ARCH)
    assert repr(tcfg) == repr(jcfg)
    tshapes = _shapes(ttf.abstract_params(tcfg))
    assert tshapes == _shapes(jtf.abstract_params(jcfg))
    total = sum(math.prod(s) for s in tshapes.values())
    # the reference's analytic count leaves out the norm scales (the
    # layers' ln, ffn_ln, q_norm and k_norm, and final_norm)
    norms = sum(math.prod(s) for p, s in tshapes.items()
                if p.rsplit("/", 1)[-1] in ("ln", "ffn_ln", "q_norm",
                                            "k_norm", "final_norm"))
    assert total - norms == jregistry.param_counts(jcfg)["total"]
    assert 30.4e9 < total < 30.6e9, total
    experts = tshapes["groups/slot0/moe/w_gate"]
    assert experts == (48, 128, 2048, 768), experts


@pytest.mark.parametrize("tokens", [1, BATCH, PREFILL_LEN,
                                    BATCH * PREFILL_LEN])
def test_capacity_matches_reference(tokens):
    cfg = tregistry.get_config(ARCH)
    cap = tmoe._capacity(cfg, tokens)
    assert cap == jmoe._capacity(jregistry.get_config(ARCH), tokens)
    # a decode step (batch 4 or 1) keeps the floor of 4; an admission of
    # 256 rows, padding included, takes 20 a expert
    assert cap == {1: 4, BATCH: 4, PREFILL_LEN: 20,
                   BATCH * PREFILL_LEN: 80}[tokens]


def test_k3_plain_route_at_e128_c20_matches_reference():
    e, c, d, f = 128, 20, 64, 48
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((e, c, d)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    got = ops.moe_ffn(*(torch.from_numpy(a) for a in (buf, w1, w3, w2)))
    want = np.asarray(jops.moe_ffn(*(jnp.asarray(a) for a in
                                     (buf, w1, w3, w2)), impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
