"""The port's training step on the CPU against the JAX package.

Reduced fp32 configs of the dense family (qwen3-0.6b, llama3.2-3b,
gemma3-4b with its "L" layers, internvl2-26b with its prefix embeddings and
-1 labels), of the MoE family (olmoe-1b-7b, qwen3-moe-30b-a3b: K3's
gradient, the router's and the auxiliary loss) and of the hybrid family
(recurrentgemma-2b: K5's gradient, the RG-LRU gates'), the same weights on
both sides: drawn with numpy from a seed
over the port's parameter shapes (the reference's key paths) and handed to
each package, so no reference ``init_params`` runs.  The training forward's
logits, the loss and the whole gradient tree equal
``jax.value_and_grad`` of the reference's loss; three steps of loss, grad
norm, lr and the parameters after them equal ``make_train_step``'s on the
reference's own batches; accumulation over two microbatches and
``grad_of_scan`` agree with one batch (as ``tests/test_models.py``
asserts for the reference); the three remat policies give the same
numbers; the SSM and encoder-decoder families raise, naming ROADMAP item
14b.

Tolerances: fp32, rtol/atol 1e-4 for logits, loss and gradients (XLA's and
ATen's CPU sums add in different orders), 2e-4 absolute for parameters
after AdamW steps of lr 1e-3 (an Adam step moves a weight by ~lr whatever
its gradient's size).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.sharding import make_rules
from repro_torch import steps
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import layers
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamWConfig

RULES = make_rules()
TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_ATOL = 2e-4
DENSE = ["qwen3-0.6b", "llama3.2-3b", "gemma3-4b", "internvl2-26b"]
MOE = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
HYBRID = ["recurrentgemma-2b"]
B, S = 2, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Training steps are many small CPU ops: one intra-op thread takes
    about as long alone and does not oversubscribe the cores that the
    other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _np_tree(shapes[k], rng) for k in sorted(shapes)}
    scale = 0.02 if len(shapes.shape) <= 1 else shapes.shape[-2] ** -0.5
    return (rng.standard_normal(shapes.shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax cfg, port cfg, numpy params, numpy batch) of one arch."""
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    rng = np.random.default_rng(sum(map(ord, arch)))
    params = _np_tree(ttf.abstract_params(tcfg), rng)
    p = tcfg.frontend_tokens
    batch = {"tokens": rng.integers(0, tcfg.vocab_size,
                                    (B, S - p)).astype(np.int32)}
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    if p:
        labels[:, :p] = -1
        batch["prefix_embeds"] = (rng.standard_normal((B, p, tcfg.d_model))
                                  * 0.02).astype(np.float32)
    batch["labels"] = labels
    return jcfg, tcfg, params, batch


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _port_loss_grads(cfg, params, batch):
    flat = list(steps.leaves(params))
    req = [t.detach().clone().requires_grad_() for t in flat]
    tree = steps.unflatten(params, req)
    logits, caches, aux = ttf.forward(
        cfg, tree, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
        mode="train")
    assert caches is None
    aux_value = float(aux.detach())
    assert aux_value > 0.0 if cfg.n_experts else aux_value == 0.0
    loss = steps.lm_loss(cfg, logits, batch["labels"], aux)
    grads = torch.autograd.grad(loss, req)
    return logits.detach(), loss.detach(), steps.unflatten(params,
                                                            list(grads))


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
def test_loss_and_gradient_tree_equal_the_reference(arch):
    jcfg, tcfg, params, batch = _setup(arch)

    def loss_fn(p, b):
        logits, _, aux = jtf.forward(jcfg, p, b["tokens"], rules=RULES,
                                     prefix_embeds=b.get("prefix_embeds"),
                                     mode="train")
        return jsteps._lm_loss(jcfg, logits, b["labels"], aux,
                               RULES), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(_jax(params), _jax(batch))
    logits, loss, grads = _port_loss_grads(tcfg, _torch(params),
                                           _torch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), want[path],
                                   err_msg=path, **TOL)


def test_three_steps_equal_make_train_step():
    """Loss, grad norm and lr of three steps, and the parameters and
    moments after them, on the reference pipeline's batches (which the
    port's pipeline reproduces)."""
    _three_steps_agree("qwen3-0.6b", moment_atol=1e-6)


def test_hybrid_three_steps_equal_make_train_step():
    """As above for recurrentgemma-2b: K5's gradient and the RG-LRU
    gates' in every step.  The reference's associative scan and K5's
    segmented one round apart, and a few tied-embedding gradients that
    cancel carry that into the first moment: its tolerance is the
    gradient's (1e-4) times m's weight on three steps' gradients (0.1 +
    0.09 + 0.081), 3e-5."""
    _three_steps_agree("recurrentgemma-2b", moment_atol=3e-5)


def _three_steps_agree(arch, moment_atol):
    jcfg, tcfg, params, _ = _setup(arch)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, RULES, JAdamWConfig(**kw)))
    jp = _jax(params)
    jstate = {"params": jp, "opt": jadamw_init(jp)}
    tstate = steps.init_train_state(tcfg, params=_torch(params))
    tstep = steps.make_train_step(tcfg, AdamWConfig(**kw))
    jpipe = JTokenPipeline(jcfg, JDataConfig(4, 32, seed=3))
    tpipe = TokenPipeline(tcfg, DataConfig(4, 32, seed=3))
    for i in range(3):
        hb = jpipe.host_batch(i)
        for k, v in tpipe.host_batch(i).items():
            np.testing.assert_array_equal(v, hb[k])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in hb.items()})
        _, tm = tstep(tstate, tpipe.device_batch(i))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    want = jax.tree.map(np.asarray, jstate)
    for tree in ("params", "m", "v"):
        t = tstate["params"] if tree == "params" else tstate["opt"][tree]
        w = want["params"] if tree == "params" else want["opt"][tree]
        got, exp = dict(_flat(t)), dict(_flat(w))
        for path in exp:
            np.testing.assert_allclose(
                got[path].numpy(), exp[path], err_msg=f"{tree}/{path}",
                rtol=1e-3,
                atol=PARAM_ATOL if tree == "params" else moment_atol)


def _step_once(cfg, params, batch, **kw):
    state = steps.init_train_state(cfg, params=_torch(params))
    _, m = steps.make_train_step(cfg, AdamWConfig(), **kw)(state, batch)
    return state, m


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-26b"])
def test_accumulation_and_grad_of_scan_equal_one_batch(arch):
    """accum 2 (fp32 sum of two microbatches' gradients) and grad_of_scan
    give accum 1's loss and update (``tests/test_models.py``'s
    accumulation check)."""
    _, cfg, params, batch = _setup(arch)
    tb = _torch(batch)
    s1, m1 = _step_once(cfg, params, tb)
    for kw in ({"accum": 2}, {"accum": 2, "grad_of_scan": True}):
        s2, m2 = _step_once(cfg, params, tb, **kw)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-4)
        for a, b in zip(steps.leaves(s1["params"]),
                        steps.leaves(s2["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                       atol=2e-4)
    with pytest.raises(NotImplementedError, match="item 13"):
        steps.make_train_step(cfg, AdamWConfig(), grad_constraint=True)


def test_remat_policies_give_the_same_numbers():
    _remat_policies_agree("gemma3-4b")


@pytest.mark.parametrize("arch", MOE)
def test_moe_remat_policies_give_the_same_numbers(arch):
    """The MoE layer's group returns (x, aux) through the checkpoint: the
    loss (aux included) and gradients are those of no remat."""
    _remat_policies_agree(arch)


@pytest.mark.parametrize("arch", HYBRID)
def test_hybrid_remat_policies_give_the_same_numbers(arch):
    """The "R" layers under the group's checkpoint: K5 runs again in the
    backward under "nothing" and "dots", with the loss and gradients of
    no remat."""
    _remat_policies_agree(arch)


def _remat_policies_agree(arch):
    _, cfg, params, batch = _setup(arch)
    tb = _torch(batch)
    results = {}
    for policy in ("nothing", "dots", "full"):
        c = cfg.replace(remat_policy=policy)
        _, loss, grads = _port_loss_grads(c, _torch(params), tb)
        results[policy] = (loss, list(steps.leaves(grads)))
    base_loss, base = results["full"]
    for policy in ("nothing", "dots"):
        loss, grads = results[policy]
        assert torch.equal(loss, base_loss), policy
        for a, b in zip(grads, base):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_grads(cfg.replace(remat_policy="some"), _torch(params),
                         tb)


@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-medium"])
def test_other_families_raise_naming_item_14b(arch):
    cfg = tregistry.get_config(arch, reduced=True)
    assert "item 14b" in steps.train_unsupported(cfg)
    with pytest.raises(NotImplementedError, match="item 14b"):
        steps.make_train_step(cfg, AdamWConfig())
    if cfg.is_encdec:
        return
    # the forward itself refuses too, at the layer it cannot train
    params = layers.zeros(ttf.abstract_params(cfg), torch.float32, "meta")
    tokens = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="item 14b"):
        ttf.forward(cfg, params, tokens, mode="train")


def test_dense_archs_are_trainable_and_batches_match_the_reference():
    for arch in DENSE + MOE + HYBRID + ["gemma3-12b"]:
        assert steps.train_unsupported(
            tregistry.get_config(arch, reduced=True)) is None, arch
    jcfg, tcfg, _, _ = _setup("internvl2-26b")
    jb = JTokenPipeline(jcfg, JDataConfig(2, 16, 5)).host_batch(7)
    tb = TokenPipeline(tcfg, DataConfig(2, 16, 5)).host_batch(7)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
