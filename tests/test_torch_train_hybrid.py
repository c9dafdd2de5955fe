"""The port's hybrid-family training on the CPU, against the JAX package.

K5's gradient: the plain version ``rglru_scan_bwd_ref`` against
``jax.vjp`` of the reference's sequential recurrence
(``repro.kernels.ref.rglru_scan``) over ragged S, with and without a start
state h0 and a final-state gradient dhf, and the custom operator's
autograd against ``torch.autograd`` of a plain sequential loop.  The
RG-LRU layer: ``apply_rglru_layer(mode="train")``'s output and gradients
(the input, the projections, the conv, the five gate leaves) against
``jax.value_and_grad`` of ``repro.models.hybrid.apply_rglru_layer``.  The
step: the fp32 gate leaves of a bf16 model keep their dtype through a
step, a checkpoint and a restore (the loss and gradient tree, three AdamW
steps and the remat policies of reduced recurrentgemma-2b against the
reference are in ``tests/test_torch_train_step.py``).  The trainer:
reduced recurrentgemma-2b through ``launch.train`` with one injected
failure ends where an uninterrupted run ends.

The reference's own draw zeroes the tail's gate leaves (every rank <= 1
leaf), which would leave their gates constant: every weight here is drawn
with numpy from a seed and handed to both packages, so ``lam``, ``w_a``,
``b_a``, ``w_i`` and ``b_i`` take gradients that are not trivial.

Tolerances: K5's gradient at 2e-4 (the RG-LRU tolerance of
``tests/test_kernels.py``; the segmented order and the sequential one
round differently), the operator against autograd of the loop at 1e-5;
the layer at rtol/atol 1e-4 (``tests/test_torch_train_step.py``'s); the
trainer's final loss within 0.05, as ``tests/test_torch_train_moe.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.sharding import make_rules
from repro_torch import steps
from repro_torch.checkpoint import restore_into, save_checkpoint
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models import hybrid as thybrid
from repro_torch.models import registry as tregistry
from repro_torch.optim import AdamWConfig

RULES = make_rules()
ARCH = "recurrentgemma-2b"
SCAN_TOL = 2e-4
TOL = dict(rtol=1e-4, atol=1e-4)
GATE_LEAVES = ("lam", "w_a", "b_a", "w_i", "b_i")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """A training run is thousands of small CPU ops; one intra-op thread
    takes about as long alone and does not oversubscribe the cores that
    the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_operands(rng, b, s, l):
    """a = sigmoid(normal), b = 0.3 normal (``tests/test_kernels.py:
    156-157``), a state h0 and the gradients dh and dhf."""
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, l))))
    return [np.asarray(v, np.float32) for v in (
        a, rng.standard_normal((b, s, l)) * 0.3,
        rng.standard_normal((b, l)), rng.standard_normal((b, s, l)),
        rng.standard_normal((b, l)))]


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


# ---------------------------------------------------------------------------
# K5's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 37, 200, 256])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dhf", [False, True])
def test_rglru_scan_bwd_ref_equals_jax_vjp_of_the_reference(s, with_h0,
                                                            with_dhf):
    rng = np.random.default_rng(1000 * s + 10 * with_h0 + with_dhf)
    a, b, h0, dh, dhf = _scan_operands(rng, 2, s, 40)
    h0 = h0 if with_h0 else None
    dhf = dhf if with_dhf else None
    if with_h0:
        (h_want, _), vjp = jax.vjp(lambda a, b, h0: jref.rglru_scan(
            a, b, h0=h0), *(jnp.asarray(v) for v in (a, b, h0)))
    else:
        (h_want, _), vjp = jax.vjp(lambda a, b: jref.rglru_scan(a, b),
                                   jnp.asarray(a), jnp.asarray(b))
    want = vjp((jnp.asarray(dh), jnp.zeros((2, 40), jnp.float32)
                if dhf is None else jnp.asarray(dhf)))
    h, _ = ops.rglru_scan(_t(a), _t(b), _t(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    da, db, dh0 = ops.rglru_scan_bwd_ref(_t(a), h, _t(h0), _t(dh), _t(dhf))
    got = (da, db) + ((dh0,) if with_h0 else ())
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL,
                                   atol=SCAN_TOL, err_msg=name)
    # the operator's CPU kernel is the plain version
    for g, w in zip(ops.rglru_scan_bwd(_t(a), h, _t(h0), _t(dh), _t(dhf)),
                    (da, db, dh0)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_gradient_equals_autograd_of_a_sequential_loop(with_h0):
    """The custom operator's ``register_autograd`` (its backward the
    ``repro_torch::rglru_scan_bwd`` operator, the plain version on the
    CPU) against autograd through h_t = a_t h_{t-1} + b_t step by step,
    with a loss on h and on the final state; then with the final state
    unused (its gradient missing)."""
    rng = np.random.default_rng(5 + with_h0)
    a, b, h0, dh, dhf = (_t(v) for v in _scan_operands(rng, 3, 45, 24))
    h0 = h0 if with_h0 else None
    ops.reset_launch_counts()

    def loop(a, b, h0):
        cur = torch.zeros_like(a[:, 0]) if h0 is None else h0
        hs = []
        for t in range(a.shape[1]):
            cur = a[:, t] * cur + b[:, t]
            hs.append(cur)
        return torch.stack(hs, 1), cur

    for use_final in (True, False):
        def grads(fn):
            ins = [t.clone().requires_grad_() for t in (a, b, h0)
                   if t is not None]
            h, hf = fn(*ins[:2], ins[2] if h0 is not None else None)
            loss = torch.sum(h * dh)
            if use_final:
                loss = loss + torch.sum(hf * dhf)
            return torch.autograd.grad(loss, ins)

        got, want = grads(ops.rglru_scan), grads(loop)
        assert len(got) == (3 if with_h0 else 2)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # the CPU takes the plain version: nothing was launched or counted, in
    # either direction
    assert ops.launch_counts()["rglru_scan"] == 0
    assert ops.route_counts()["rglru_scan"] == {"fwd": 0, "bwd": 0}


def test_rglru_scan_bwd_checks_its_operands():
    a, b, h0, dh, dhf = (_t(v) for v in _scan_operands(
        np.random.default_rng(3), 2, 9, 8))
    h, _ = ops.rglru_scan(a, b, h0)
    got = ops.rglru_scan_bwd(a, h, h0, dh, dhf)
    assert [t.shape for t in got] == [a.shape, a.shape, h0.shape]
    with pytest.raises(ValueError, match="dh"):
        ops.rglru_scan_bwd(a, h, h0, dh[:, :4], dhf)
    with pytest.raises(ValueError, match="dhf"):
        ops.rglru_scan_bwd(a, h, h0, dh, dhf[:1])
    with pytest.raises(ValueError, match="dh"):
        ops.rglru_scan_bwd(a, h, h0, dh.double(), dhf)
    with pytest.raises(ValueError):
        ops.rglru_scan_bwd(a, h[:, :4], h0, dh, dhf)


# ---------------------------------------------------------------------------
# the RG-LRU layer's training forward
# ---------------------------------------------------------------------------
def _layer_params(cfg, rng):
    """One recurrent layer's weights: the gate leaves drawn whole (the
    reference's draw would zero them), the rest scaled."""
    out = {}
    for name, leaf in thybrid.rglru_shapes(cfg).items():
        x = rng.standard_normal(leaf.shape)
        if name not in GATE_LEAVES:
            x = x * (0.1 if len(leaf.shape) == 1 else leaf.shape[0] ** -0.5)
        out[name] = x.astype(np.float32)
    return out


@pytest.mark.parametrize("s", [16, 37])
def test_apply_rglru_layer_train_value_and_grad_equal_the_reference(s):
    """loss = sum(out * r) through both layers from zero state: the output
    and the gradients of x and of every leaf."""
    jcfg = jregistry.get_config(ARCH, reduced=True)
    tcfg = tregistry.get_config(ARCH, reduced=True)
    rng = np.random.default_rng(s)
    layer = _layer_params(tcfg, rng)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, cache = jhybrid.apply_rglru_layer(jcfg, p, x, rules=RULES,
                                               mode="train")
        assert cache is None
        return jnp.sum(out * r), out

    (jl, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = thybrid.apply_rglru_layer(tcfg, tp, tx, mode="train",
                                           cache=None)
    assert cache is None
    loss = torch.sum(out * torch.from_numpy(r))
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               err_msg="x", **TOL)
    for name, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]),
                                   err_msg=name, **TOL)
        if name in GATE_LEAVES:
            assert float(g.abs().max()) > 1e-3, name


def test_apply_rglru_layer_train_takes_no_cache():
    cfg = tregistry.get_config(ARCH, reduced=True)
    p = {k: torch.from_numpy(v) for k, v in
         _layer_params(cfg, np.random.default_rng(0)).items()}
    x = torch.zeros((1, 4, cfg.d_model))
    cache = {k: torch.zeros(leaf.shape, dtype=leaf.dtype or torch.float32)
             for k, leaf in thybrid.rglru_cache_shapes(cfg, 1).items()}
    with pytest.raises(ValueError, match="no cache"):
        thybrid.apply_rglru_layer(cfg, p, x, mode="train", cache=cache)
    with pytest.raises(ValueError, match="mode"):
        thybrid.apply_rglru_layer(cfg, p, x, mode="suffix", cache=cache)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_fp32_gate_leaves_keep_their_dtype_through_a_step_and_a_restore(
        tmp_path):
    """A bf16 recurrentgemma's trained leaves mix dtypes: the five gate
    leaves of every "R" layer stay fp32 through an AdamW step, a
    checkpoint and a restore into the resident state, the rest bf16; the
    moments are fp32 throughout."""
    cfg = tregistry.get_config(ARCH, reduced=True).replace(dtype="bfloat16")
    state = steps.init_train_state(cfg, 0, device="cpu")
    pipe = TokenPipeline(cfg, DataConfig(2, 16, 0))
    before = {p: t.clone() for p, t in _flat(state["params"])}
    _, m = steps.make_train_step(cfg, AdamWConfig(lr=1e-3))(
        state, pipe.device_batch(0))
    assert np.isfinite(float(m["loss"]))

    def dtypes(tree):
        return {p: t.dtype for p, t in _flat(tree)}

    want = {p: torch.float32 if p.split("/")[-1] in GATE_LEAVES
            else torch.bfloat16 for p in before}
    assert sum(d == torch.float32 for d in want.values()) == 5 * 4
    assert dtypes(state["params"]) == want
    assert set(dtypes(state["opt"]["m"]).values()) == {torch.float32}
    moved = [p for p, t in _flat(state["params"])
             if p.split("/")[-1] in GATE_LEAVES and
             not torch.equal(t, before[p])]
    assert moved, "no gate leaf moved"
    save_checkpoint(tmp_path, 1, state)
    saved = {p: t.clone() for p, t in _flat(state)}
    for t in steps.leaves(state["params"]):
        t.zero_()
    assert restore_into(tmp_path, state) == 1
    assert dtypes(state["params"]) == want
    for p, t in _flat(state):
        assert t.dtype == saved[p].dtype and torch.equal(t, saved[p]), p


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_train_recurrentgemma_survives_a_failure_on_the_path_of_an_unbroken_run(
        tmp_path):
    kw = dict(reduced=True, steps=12, global_batch=4, seq_len=32,
              ckpt_every=4, lr=1e-3, log_every=100, device="cpu")
    r1 = train(ARCH, ckpt_dir=str(tmp_path / "a"), **kw)
    r2 = train(ARCH, ckpt_dir=str(tmp_path / "b"), fail_at=[6], **kw)
    assert r1["restarts"] == 0 and r2["restarts"] == 1
    assert r2["final_step"] == 11
    # the restart resumes after the checkpoint at step 4: 5 runs twice
    assert r2["steps_run"] == r2["telemetry_points"] == 12 + 1
    assert all(np.isfinite(r1["losses"]))
    assert r1["final_loss"] < r1["first_loss"]
    assert abs(r1["final_loss"] - r2["final_loss"]) < 0.05, (r1, r2)
