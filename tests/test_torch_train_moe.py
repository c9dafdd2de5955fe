"""The port's MoE training on the CPU, against the JAX package.

K3's gradient: the plain version ``moe_ffn_bwd_ref`` against ``jax.vjp``
of the reference's FFN einsums (``repro.kernels.ref.moe_ffn``), with
per-expert row counts that leave an expert empty, and the custom
operator's autograd against autograd through ``moe_ffn_ref``, and the
card's gate for K3's tensor-core backward (``chip_smoke.py`` phase 31
(a)) against another summation order and a control.  The MoE
layer: ``apply_moe``'s output, auxiliary loss and gradients (the input,
the router and the three expert weights) against ``jax.value_and_grad`` of
``repro.models.moe.apply_moe``, at the default capacity and at one small
enough to drop tokens.  The trainer: reduced olmoe-1b-7b through
``launch.train`` with one injected failure ends where an uninterrupted run
ends.

Tolerances: K3's gradient in fp32 at 3e-4 (``tests/test_kernels.py``'s
MoE tolerance; XLA's and ATen's CPU products sum in other orders), the
operator against autograd at 1e-5 (the same fp32 products, grouped
differently), 5e-2 in bf16 (``tests/test_kernels.py``); the layer at
rtol/atol 1e-4 (``tests/test_torch_moe.py``'s model tolerance); the
trainer's final loss within 0.05, as ``tests/test_torch_train_e2e.py``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.sharding import make_rules
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry

RULES = make_rules()
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
KERNEL_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """A training run is thousands of small CPU ops; one intra-op thread
    takes about as long alone and does not oversubscribe the cores that
    the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ffn_operands(rng, e, c, d, f):
    return [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
        ((e, c, d), 0.5), ((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
        ((e, f, d), f ** -0.5), ((e, c, d), 1.0))]


def _live(counts, e, c):
    return (np.arange(c)[None, :] < counts[:, None])[..., None]


# ---------------------------------------------------------------------------
# K3's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f,counts", [
    (3, 16, 32, 24, [16, 0, 5]),          # an empty expert
    (4, 37, 40, 72, [37, 12, 0, 36]),      # ragged C, d and f
    (2, 8, 16, 16, None)])                 # every row live
def test_moe_ffn_bwd_ref_equals_jax_vjp_of_the_reference(e, c, d, f,
                                                         counts):
    rng = np.random.default_rng(e * 1000 + c)
    buf, w1, w3, w2, dy = _ffn_operands(rng, e, c, d, f)
    live = _live(np.array(counts if counts is not None else [c] * e), e, c)

    def ffn(buf, w1, w3, w2):
        return jnp.where(live, jref.moe_ffn(buf, w1, w3, w2), 0.0)

    _, vjp = jax.vjp(ffn, *(jnp.asarray(a) for a in (buf, w1, w3, w2)))
    want = vjp(jnp.asarray(dy))
    n = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    got = ops.moe_ffn_bwd_ref(*(torch.from_numpy(a) for a in
                                (buf, w1, w3, w2, dy)), n)
    tol = KERNEL_TOL["float32"]
    for name, g, w in zip(("dbuf", "dw1", "dw3", "dw2"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol, err_msg=name)
    if counts is not None:
        # rows past a count take no gradient; an empty expert's weights
        # none at all
        assert not got[0].numpy()[~np.broadcast_to(live, got[0].shape)].any()
        empty = counts.index(0)
        assert all(not t[empty].any() for t in got[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_gradient_equals_autograd_of_the_plain_version(dtype):
    """The custom operator's ``register_autograd`` (its backward the
    ``repro_torch::moe_ffn_bwd`` operator, the plain version on the CPU)
    against autograd through ``moe_ffn_ref``: the same function."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    arrays = _ffn_operands(rng, 3, 12, 24, 40)
    buf, w1, w3, w2, dy = (torch.from_numpy(a).to(dt) for a in arrays)
    counts = torch.tensor([12, 0, 7], dtype=torch.int32)
    ops.reset_launch_counts()

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (buf, w1, w3, w2)]
        return torch.autograd.grad(fn(*ins, counts), ins, dy)

    got, want = grads(ops.moe_ffn), grads(ops.moe_ffn_ref)
    tol = 1e-5 if dtype == "float32" else KERNEL_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dt
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    # the CPU takes the plain version: nothing was launched or counted,
    # on either of the backward's routes
    assert ops.launch_counts()["moe_ffn"] == 0
    assert ops.route_counts()["moe_ffn"]["bwd_wgmma"] == 0
    assert ops.route_counts()["moe_ffn"]["bwd_simt"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_bwd_ref_ignores_what_lies_past_the_counts(dtype):
    """buf and dy with NaN in every row past each count (counts not
    multiples of 16, one expert empty) give the same four gradients, bit
    for bit, as with zeros there: dbuf 0 past the counts, the empty
    expert's weight gradients 0.  Phase 31's poisoned case holds the
    kernel to this rule."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    e, c, d, f = 4, 24, 16, 12
    counts = np.array([24, 0, 5, 13])
    live = torch.from_numpy(_live(counts, e, c))
    buf, w1, w3, w2, dy = (torch.from_numpy(a).to(dt)
                           for a in _ffn_operands(rng, e, c, d, f))
    n = torch.from_numpy(counts.astype(np.int32))
    zeros = [torch.where(live, t, torch.zeros_like(t)) for t in (buf, dy)]
    nans = [torch.where(live, t, torch.full_like(t, float("nan")))
            for t in (buf, dy)]
    want = ops.moe_ffn_bwd_ref(zeros[0], w1, w3, w2, zeros[1], n)
    for got in (ops.moe_ffn_bwd_ref(nans[0], w1, w3, w2, nans[1], n),
                ops.moe_ffn_bwd(nans[0], w1, w3, w2, nans[1], n)):
        for g, w in zip(got, want):
            assert bool(g.isfinite().all())
            assert torch.equal(g, w)
        assert not got[0][~live.expand(e, c, d)].any()
        assert all(not t[1].any() for t in got[1:])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k3_backward_gate_refuses_a_kernel_that_rounds_dh():
    """``chip_smoke.py`` phase 31 (a)'s gate for K3's wgmma backward, on a
    small bf16 call: its plain version spelled out is ``moe_ffn_bwd_ref``
    bit for bit; the same function summed in another order (d permuted,
    so every fp32 sum over d takes its terms in another order) moves some
    of H, dG and dU to the other bf16 neighbour and passes; the control
    (dH rounded to bf16 before the SwiGLU gradient) does not."""
    cs = _chip_smoke()
    e, c, d, f = 4, 128, 512, 256
    counts = np.array([128, 0, 37, 101])
    buf, w1, w3, w2, dy = (torch.from_numpy(a).to(torch.bfloat16)
                           for a in _ffn_operands(np.random.default_rng(12),
                                                  e, c, d, f))
    n = torch.from_numpy(counts.astype(np.int32))
    live = torch.from_numpy(_live(counts, e, c))
    want = ops.moe_ffn_bwd_ref(buf, w1, w3, w2, dy, n)
    mids, plain = cs.k3_plain_parts(torch, buf, w1, w3, w2, dy, n)
    assert all(torch.equal(a, b) for a, b in zip(plain, want))
    assert cs.k3_backward_verdict(plain, mids, want, mids, live)["ok"]

    p = torch.from_numpy(np.random.default_rng(13).permutation(d))
    q = torch.argsort(p)
    other_mids, other = cs.k3_plain_parts(
        torch, buf[..., p], w1[:, p], w3[:, p], w2[..., p], dy[..., p], n)
    other = (other[0][..., q], other[1][:, q], other[2][:, q],
             other[3][..., q])
    sound = cs.k3_backward_verdict(other, other_mids, want, mids, live)
    assert sound["ok"], sound
    assert max(sound["intermediate_share_off"].values()) > 0, sound

    control_mids, control = cs.k3_plain_parts(torch, buf, w1, w3, w2, dy, n,
                                              dh_bf16=True)
    refused = cs.k3_backward_verdict(control, control_mids, want, mids, live)
    assert not refused["ok"], refused
    assert max(refused["dw_normwise"].values()) > cs.K3_DW_NORMWISE
    assert max(refused["intermediate_share_off"].values()) > cs.K3_SHARE_OFF


def test_moe_ffn_bwd_checks_its_output_gradient():
    buf, w1, w3, w2, dy = (torch.from_numpy(a) for a in _ffn_operands(
        np.random.default_rng(8), 2, 4, 8, 6))
    got = ops.moe_ffn_bwd(buf, w1, w3, w2, dy)
    assert [t.shape for t in got] == [t.shape for t in (buf, w1, w3, w2)]
    with pytest.raises(ValueError, match="dy"):
        ops.moe_ffn_bwd(buf, w1, w3, w2, dy[:1])
    with pytest.raises(ValueError, match="dy"):
        ops.moe_ffn_bwd(buf, w1, w3, w2, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="counts"):
        ops.moe_ffn_bwd(buf, w1, w3, w2, dy, torch.tensor([1, 2]))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_apply_moe_value_and_grad_equal_the_reference(arch,
                                                      capacity_factor):
    """loss = sum(out * r) + 0.01 aux through both layers: the output, the
    aux loss and the gradients of x, the router and the three expert
    weights.  At capacity factor 0.5 (capacity 8 of the 16 choices an
    expert gets on average) tokens are dropped."""
    jcfg = jregistry.get_config(arch, reduced=True).replace(
        capacity_factor=capacity_factor)
    tcfg = tregistry.get_config(arch, reduced=True).replace(
        capacity_factor=capacity_factor)
    rng = np.random.default_rng(sum(map(ord, arch)))
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    layer = {k: (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
             for k, s in (("router", (d, e)), ("w_gate", (e, d, f)),
                          ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    r = rng.standard_normal((2, 32, d)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.apply_moe(jcfg, p, x, RULES)
        return jnp.sum(out * r) + 0.01 * aux, (out, aux)

    (jl, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.apply_moe(tcfg, tp, tx)
    loss = torch.sum(out * torch.from_numpy(r)) + 0.01 * aux
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               err_msg="x", **TOL)
    for name, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]),
                                   err_msg=name, **TOL)
    if capacity_factor < 1:
        # the drops happened: some expert was chosen more than capacity
        probs = torch.softmax(torch.from_numpy(x.reshape(-1, d)
                                               @ layer["router"]), -1)
        _, top = tmoe.top_k(probs, tcfg.experts_per_token)
        assert tmoe._capacity(tcfg, 64) == 8
        assert torch.bincount(top.flatten(), minlength=e).max() > 8


def test_dispatch_gradient_equals_the_plain_gather(monkeypatch):
    """The dispatch's gradient written as a gather in ascending expert id
    gives the scatter-add of the plain ``xf[src] * occ``'s autograd."""
    cfg = tregistry.get_config("olmoe-1b-7b", reduced=True).replace(
        capacity_factor=0.5)
    rng = np.random.default_rng(11)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"router": torch.from_numpy(rng.standard_normal((d, e)).astype(
             np.float32)),
         "w_gate": torch.from_numpy(rng.standard_normal((e, d, f)).astype(
             np.float32) * 0.1),
         "w_up": torch.from_numpy(rng.standard_normal((e, d, f)).astype(
             np.float32) * 0.1),
         "w_down": torch.from_numpy(rng.standard_normal((e, f, d)).astype(
             np.float32) * 0.1)}
    x = torch.from_numpy(rng.standard_normal((2, 32, d)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 32, d)).astype(np.float32))

    def dx():
        xr = x.clone().requires_grad_()
        out, _ = tmoe.apply_moe(cfg, p, xr)
        return torch.autograd.grad(out, xr, dy)[0]

    got = dx()
    monkeypatch.setattr(tmoe._Dispatch, "apply", staticmethod(
        lambda xf, src, occ, *_: xf[src] * occ[..., None].to(xf.dtype)))
    want = dx()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_train_olmoe_survives_a_failure_on_the_path_of_an_unbroken_run(
        tmp_path):
    kw = dict(reduced=True, steps=12, global_batch=4, seq_len=32,
              ckpt_every=4, lr=1e-3, log_every=100, device="cpu")
    r1 = train("olmoe-1b-7b", ckpt_dir=str(tmp_path / "a"), **kw)
    r2 = train("olmoe-1b-7b", ckpt_dir=str(tmp_path / "b"), fail_at=[6],
               **kw)
    assert r1["restarts"] == 0 and r2["restarts"] == 1
    assert r2["final_step"] == 11
    # the restart resumes after the checkpoint at step 4: 5 runs twice
    assert r2["steps_run"] == r2["telemetry_points"] == 12 + 1
    assert np.isfinite(r1["final_loss"])
    assert r1["final_loss"] < r1["first_loss"]
    assert abs(r1["final_loss"] - r2["final_loss"]) < 0.05, (r1, r2)
