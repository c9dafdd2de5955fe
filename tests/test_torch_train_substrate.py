"""The training substrate of the port on the CPU, against the JAX package:
AdamW (schedule, clipping, moments, decay; the functional and the in-place
form) against ``repro.optim.adamw_update``; the token pipeline's batches
byte for byte against ``repro.data.TokenPipeline`` (dense, prefix and
encoder-decoder archs, bf16 leaves through the device batch); checkpoints
(the reference's layout, round trips in fp32 and bf16, atomic saves,
``keep``, restoring into bound storage, ``np.save``'s bytes at any
staging chunk); and a checkpoint the JAX package
wrote, restored by the port, whose next step's loss equals the
reference's.  fp32 tolerances rtol/atol 1e-5 for AdamW (both sides run the
same elementwise ops in the same order) and 1e-4 for the loss."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.checkpoint import save_checkpoint as jsave
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import registry as jregistry
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.sharding import make_rules
from repro_torch import steps
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, restore_into,
                                    save_checkpoint)
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               adamw_update_, cosine_schedule)

RULES = make_rules()


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((7,)) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 3, 4)) * scale
                        ).astype(np.float32)}}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_cosine_schedule_equals_the_reference():
    cfg = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    jcfg = JAdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(
            float(cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))),
            float(jcosine(jcfg, jnp.asarray(step, jnp.int32))), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_adamw_equals_the_reference_over_steps(clip):
    """Four steps of both forms against ``adamw_update``, the clip binding
    (0.05) or not, through warm-up into the cosine."""
    rng = np.random.default_rng(7)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip,
              weight_decay=0.1)
    cfg, jcfg = AdamWConfig(**kw), JAdamWConfig(**kw)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw_init(jp)
    tp = _t(params)
    tstate = adamw_init(tp)
    ip = _t(params)                         # the in-place form's tree
    istate = adamw_init(ip)
    storage = [t.data_ptr() for t in steps.leaves(ip)]
    for i in range(4):
        grads = _tree(rng, scale=0.5)
        jp, jstate, jm = jadamw_update(jcfg, jax.tree.map(jnp.asarray,
                                                          grads), jstate, jp)
        tp, tstate, tm = adamw_update(cfg, _t(grads), tstate, tp)
        im = adamw_update_(cfg, _t(grads), istate, ip)
        for m in (tm, im):
            for key in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                           rtol=1e-6, err_msg=key)
        for a, b, c in zip(_leaves(jp), steps.leaves(tp), steps.leaves(ip)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(c.numpy(), a, rtol=1e-5, atol=1e-6)
        for name in ("m", "v"):
            for a, b in zip(_leaves(jstate[name]),
                            steps.leaves(istate[name])):
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                           atol=1e-7)
    assert int(istate["step"]) == int(tstate["step"]) == 4
    assert [t.data_ptr() for t in steps.leaves(ip)] == storage


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,reduced", [
    ("qwen3-0.6b", True), ("internvl2-26b", True),
    ("seamless-m4t-medium", True), ("internvl2-26b", False)])
def test_host_batch_equals_the_reference_byte_for_byte(arch, reduced):
    jcfg = jregistry.get_config(arch, reduced=reduced)
    tcfg = tregistry.get_config(arch, reduced=reduced)
    seq = tcfg.frontend_tokens + 12 if tcfg.frontend_tokens else 16
    jp = JTokenPipeline(jcfg, JDataConfig(2, seq, seed=11))
    tp = TokenPipeline(tcfg, DataConfig(2, seq, seed=11))
    for step in (0, 5):
        want, got = jp.host_batch(step), tp.host_batch(step)
        dev = tp.device_batch(step)
        assert want.keys() == got.keys() == dev.keys()
        for k in want:
            w = np.asarray(want[k])
            if w.dtype == ml_dtypes.bfloat16:
                # numpy has no bf16 in the port: the host leaf is float32,
                # the device batch rounds it as the reference's astype
                assert got[k].dtype == np.float32
                bits = dev[k].view(torch.int16).numpy().view(np.uint16)
                np.testing.assert_array_equal(bits, w.view(np.uint16))
            else:
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w)
                np.testing.assert_array_equal(dev[k].numpy(), w)


def test_prefetching_run_yields_the_stream_and_stops_early():
    cfg = tregistry.get_config("qwen3-0.6b", reduced=True)
    pipe = TokenPipeline(cfg, DataConfig(2, 8, seed=1))
    got = list(pipe.run(3, 4))
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      pipe.host_batch(s)["tokens"])
    # a consumer that stops at a failure leaves no producer behind
    it = pipe.run(0, 50)
    next(it)
    it.close()
    assert not pipe._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {"embed": torch.randn((8, 4), generator=g).to(dtype),
         "groups": {"slot0": {"w": torch.randn((2, 4, 4),
                                               generator=g).to(dtype)}}}
    return {"params": p, "opt": adamw_init(p)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_in_the_reference_layout(tmp_path, dtype):
    state = _state(dtype)
    state["opt"]["step"].fill_(7)
    manifest = save_checkpoint(tmp_path, 7, state)
    assert (tmp_path / "LATEST").read_text() == "7"
    on_disk = json.loads((tmp_path / "step_7" / "MANIFEST.json").read_text())
    assert on_disk["leaves"] == manifest["leaves"]
    assert set(on_disk["leaves"]) == {
        "params/embed", "params/groups/slot0/w", "opt/m/embed",
        "opt/m/groups/slot0/w", "opt/v/embed", "opt/v/groups/slot0/w",
        "opt/step"}
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert on_disk["leaves"]["params/embed"]["dtype"] == name
    assert on_disk["leaves"]["opt/step"] == {
        "file": on_disk["leaves"]["opt/step"]["file"], "shape": [],
        "dtype": "int32"}
    loaded, step = load_checkpoint(tmp_path, _state(dtype, seed=1))
    assert step == 7
    for a, b in zip(steps.leaves(loaded), steps.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # restoring into a bound tree keeps its storage
    other = _state(dtype, seed=2)
    ptrs = [t.data_ptr() for t in steps.leaves(other)]
    assert restore_into(tmp_path, other) == 7
    assert [t.data_ptr() for t in steps.leaves(other)] == ptrs
    for a, b in zip(steps.leaves(other), steps.leaves(state)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="wants"):
        bad = _state(dtype)
        bad["params"]["embed"] = torch.zeros((8, 5), dtype=dtype)
        load_checkpoint(tmp_path, bad)
    with pytest.raises(NotImplementedError, match="item 13"):
        load_checkpoint(tmp_path, state, mesh=object(),
                        broadcast_axis="data")


@pytest.mark.parametrize("chunk", [1, 6, 64, None])
def test_checkpoint_files_are_np_save_bytes_at_any_chunk(tmp_path,
                                                         monkeypatch, chunk):
    """A leaf's file is ``np.save``'s bytes of the leaf (bf16 as its
    uint16 bits) and restores bit for bit whatever the staging chunk, an
    empty leaf included; a Fortran-order file takes the whole-file read."""
    import repro_torch.checkpoint.checkpoint as ckmod
    if chunk is not None:
        monkeypatch.setattr(ckmod, "_CHUNK", chunk)
    g = torch.Generator().manual_seed(3)
    tree = {"bf": torch.randn((5, 3), generator=g).to(torch.bfloat16),
            "f32": torch.randn((7,), generator=g),
            "i64": torch.arange(4, dtype=torch.int64).reshape(2, 2),
            "empty": torch.zeros((0, 3)),
            "n": torch.tensor(9, dtype=torch.int32)}
    manifest = save_checkpoint(tmp_path, 1, tree)
    for path, leaf in tree.items():
        want = leaf.view(torch.int16).numpy().view(np.uint16) \
            if leaf.dtype == torch.bfloat16 else leaf.numpy()
        np.save(tmp_path / "want.npy", want)
        got = tmp_path / "step_1" / manifest["leaves"][path]["file"]
        assert got.read_bytes() == (tmp_path / "want.npy").read_bytes()
    np.save(tmp_path / "step_1" / manifest["leaves"]["i64"]["file"],
            np.asfortranarray(np.array([[0, 3], [1, 4]], dtype=np.int64)))
    other = {k: torch.full_like(v, 0) for k, v in tree.items()}
    assert restore_into(tmp_path, other) == 1
    for k in ("bf", "f32", "empty", "n"):
        assert torch.equal(other[k], tree[k])
    assert other["i64"].tolist() == [[0, 3], [1, 4]]


def test_checkpoint_saves_are_atomic_and_keep_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    assert not mgr.has_checkpoint() and latest_step(tmp_path) is None
    state = _state()
    for s in (3, 6, 9):
        mgr.save(s, state)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_6", "step_9"]
    assert latest_step(tmp_path) == 9 and len(mgr.save_times) == 3
    # a save that died half way leaves a temporary directory that nothing
    # reads, and the next save of that step replaces it
    (tmp_path / ".tmp_step_12").mkdir()
    (tmp_path / ".tmp_step_12" / "junk.npy").write_bytes(b"torn")
    assert latest_step(tmp_path) == 9
    mgr.save(12, state)
    assert not (tmp_path / ".tmp_step_12").exists()
    # LATEST naming a step whose manifest is gone is no checkpoint
    (tmp_path / "LATEST").write_text("15")
    assert latest_step(tmp_path) is None
    assert mgr.program_store.directory == tmp_path / "programs"


def test_port_reads_what_the_reference_wrote(tmp_path):
    """A bf16 tree (ml_dtypes, stored as |V2) bit for bit; then a train
    state the JAX package saved after one step, restored into the port's
    bound state: the next step's loss and metrics equal the reference's."""
    rng = np.random.default_rng(4)
    bf = (rng.standard_normal((3, 5))).astype(ml_dtypes.bfloat16)
    jsave(tmp_path / "bf", 2, {"x": jnp.asarray(bf),
                               "n": jnp.asarray(3, jnp.int32)})
    got, step = load_checkpoint(
        tmp_path / "bf", {"x": torch.zeros((3, 5), dtype=torch.bfloat16),
                          "n": torch.zeros((), dtype=torch.int32)})
    assert step == 2 and int(got["n"]) == 3
    np.testing.assert_array_equal(
        got["x"].view(torch.int16).numpy().view(np.uint16),
        bf.view(np.uint16))

    arch = "qwen3-0.6b"
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    params = {k: v for k, v in jax.tree.map(
        lambda leaf: (rng.standard_normal(leaf.shape)
                      * 0.05).astype(np.float32),
        ttf.abstract_params(tcfg),
        is_leaf=lambda x: hasattr(x, "shape")).items()}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, RULES, JAdamWConfig(**kw)))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jp, "opt": jadamw_init(jp)}
    pipe = JTokenPipeline(jcfg, JDataConfig(2, 16, seed=0))
    jstate, _ = jstep(jstate, pipe.host_batch(0))
    jsave(tmp_path / "ck", 0, jstate)
    _, jm = jstep(jstate, pipe.host_batch(1))

    tstate = steps.init_train_state(tcfg, 5)
    ptrs = [t.data_ptr() for t in steps.leaves(tstate)]
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.restore_into(tstate) == 0
    assert [t.data_ptr() for t in steps.leaves(tstate)] == ptrs
    assert int(tstate["opt"]["step"]) == 1
    tpipe = TokenPipeline(tcfg, DataConfig(2, 16, seed=0))
    _, tm = steps.make_train_step(tcfg, AdamWConfig(**kw))(
        tstate, tpipe.device_batch(1))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, err_msg=key)
