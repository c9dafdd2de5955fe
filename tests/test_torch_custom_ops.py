"""K1-K5 as ``torch.library`` custom operators (``repro_torch::<name>``):
each fake (shape-only) version gives the shapes, dtypes and strides of
the CPU route, the strided head view included, and ``torch.export``
traces a function through each operator as one node."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

RNG = np.random.default_rng(0)


def _t(*shape, dtype=torch.float32):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _cases():
    embed = _t(96, 32)
    a, b = torch.rand(2, 20, 24), _t(2, 20, 24)
    x = _t(2, 40, 3, 8)
    return {
        "matmul": [(ops.matmul, (_t(5, 32), _t(32, 48)), {}),
                   (ops.matmul, (_t(3, 32, dtype=torch.bfloat16),
                                 _t(32, 16, dtype=torch.bfloat16)), {}),
                   # the tied head reads embed.t() in place
                   (ops.matmul, (_t(4, 32), embed.t()), {})],
        "flash_attention": [
            (ops.flash_attention, (_t(4, 7, 16), _t(2, 9, 16), _t(2, 9, 16)),
             {}),
            (ops.flash_attention, (_t(4, 3, 16), _t(2, 12, 16),
                                   _t(2, 12, 16)),
             {"causal": True, "window": 4,
              "q_start": torch.tensor([5], dtype=torch.int32)})],
        "moe_ffn": [(ops.moe_ffn, (_t(3, 4, 16), _t(3, 16, 24),
                                   _t(3, 16, 24), _t(3, 24, 16)),
                     {"counts": torch.tensor([4, 0, 2],
                                             dtype=torch.int32)})],
        "ssd_scan": [(ops.ssd_scan,
                      (x, torch.rand(2, 40, 3), -torch.rand(3),
                       _t(2, 40, 16), _t(2, 40, 16), _t(2, 3, 8, 16)),
                      {"chunk": 16})],
        "rglru_scan": [(ops.rglru_scan, (a, b, _t(2, 24)), {}),
                       (ops.rglru_scan, (a, b), {})],
    }


def _meta(v):
    return v.to("meta") if isinstance(v, torch.Tensor) else v


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_fake_version_matches_the_cpu_route(name):
    for fn, args, kw in _cases()[name]:
        cpu = _flat(fn(*args, **kw))
        fake = _flat(fn(*map(_meta, args),
                        **{k: _meta(v) for k, v in kw.items()}))
        assert len(cpu) == len(fake)
        for c, f in zip(cpu, fake):
            assert f.device.type == "meta"
            assert (c.shape, c.dtype, c.stride()) == \
                (f.shape, f.dtype, f.stride()), name


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_export_traces_each_kernel_as_one_operator(name):
    fn, args, kw = _cases()[name][0]

    class Call(torch.nn.Module):
        def forward(self, *a):
            return fn(*a, **kw)

    ep = torch.export.export(Call(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count(f"repro_torch.{name}.default") == 1, targets
    want = _flat(fn(*args, **kw))
    got = _flat(ep.module()(*args))
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_the_cpu_route_counts_no_launch():
    ops.reset_launch_counts()
    for cases in _cases().values():
        for fn, args, kw in cases:
            fn(*args, **kw)
    assert set(ops.launch_counts().values()) == {0}
