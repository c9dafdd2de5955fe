"""The port's spec bench (``repro_torch.bench.spec``) at the reference's
smoke size on the CPU, in fp32, against ``benchmarks/bench_spec.py`` on
the same weights (the reference engine's seed-0 draw, bridged): the probed
prompt, the simulated verify steps, every stream, decode and verify
steps, drafts and accepted drafts are equal.  ``bench_spec.run`` asserts
a decode speedup that a CPU run may miss, so its engines are driven here
as it drives them, and no speed is asserted on either side."""
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_spec  # noqa: E402
from repro.engine_config import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine_config import SpecConfig as JSpecConfig  # noqa: E402
from repro.launch.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.bench import spec  # noqa: E402
from test_torch_bench_serve import port_params  # noqa: E402

ARCH = "qwen3-0.6b"


def _jax_spec():
    """``bench_spec.run(smoke=True)``'s engines, without its speed gate."""
    batch, max_len, prefill_len = 2, 256, 128
    max_new, k, ngram, n_req, n_cand = 48, 12, 2, 4, 16
    config = JEngineConfig(reduced=True, batch=batch, max_len=max_len,
                           prefill_len=prefill_len, clock="step", seed=0)
    base = JServingEngine(ARCH, config)
    rng = np.random.default_rng(0)
    cands = []
    for _ in range(n_cand):
        seed = rng.integers(1, base.cfg.vocab_size, size=8)
        warm = base.reference_generate(seed, 96)
        prompt = np.concatenate([seed, np.asarray(warm)])[-prefill_len:]
        cont = base.reference_generate(prompt, max_new)
        cands.append((bench_spec.simulate_spec_steps(prompt, cont, k,
                                                     ngram), prompt))
    cands.sort(key=lambda c: c[0])
    prompts = [cands[0][1]] * n_req
    base.drain_completed()
    eng = JServingEngine(ARCH, config.replace(
        spec=JSpecConfig(k=k, ngram=ngram)), params=base.params)
    for e in (base, eng):
        e.submit(prompts[0][:8], max_new=4)
        e.run()
        e.drain_completed()
    base_reqs = [base.submit(p, max_new=max_new) for p in prompts]
    base_stats = base.run()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    stats = eng.run()
    assert all(b.generated == s.generated for b, s in zip(base_reqs, reqs))
    return cands[0], base_stats, stats, [r.generated for r in reqs]


def test_spec_bench_smoke_matches_reference():
    (sim_steps, prompt), base_stats, stats, streams = _jax_spec()
    port = spec.run(ARCH, full=False, device="cpu", smoke=True,
                    params=port_params(ARCH))
    assert port["workload"]["simulated_spec_steps"] == sim_steps
    assert port["workload"]["prompt"] == prompt.tolist()
    assert port["streams"] == streams
    assert port["baseline"]["decode_steps"] == base_stats["decode_steps"]
    assert port["spec"]["decode_steps"] == stats["decode_steps"]
    for key, jkey in (("verify_steps", "spec_steps"),
                      ("draft_tokens", "draft_tokens"),
                      ("accepted_drafts", "accepted_drafts")):
        assert port["spec"][key] == stats[jkey], key
    assert port["token_exact"] and port["workload"]["requests"] == 4
