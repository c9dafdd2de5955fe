"""The serving engine's warm boot from a program store on the CPU with
the speculative ``verify`` and the fused ``decode_horizon`` programs
(qwen3-0.6b reduced, fp32): every program installs from the store, no
program function runs, and the streams and the verify and horizon
counts equal the cold boot's.  On the card these two programs export for
tens of seconds each at full width, so the chip script persists the
plain engine's programs alone."""
import numpy as np

from repro_torch.bench import boot as boot_bench
from repro_torch.core.program_store import ProgramStore
from repro_torch.engine_config import EngineConfig, HorizonConfig, SpecConfig
from repro_torch.launch.serve import ServingEngine


def test_engine_warm_boot_with_verify_and_horizon(tmp_path):
    """A repeating prompt draws n-gram proposals (verify steps); the other
    prompt's steps without one fall back to horizons."""
    kw = dict(batch=2, max_len=48, clock="step", device="cpu",
              spec=SpecConfig(k=3), horizon=HorizonConfig(4))
    prompts = [np.asarray([5, 6, 7, 5, 6, 7, 5, 6]), np.arange(20, 29)]

    def serve(eng):
        reqs = [eng.submit(p, max_new=10) for p in prompts]
        stats = eng.run()
        return [r.generated for r in reqs], stats

    cold = ServingEngine("qwen3-0.6b", EngineConfig(**kw),
                         store=ProgramStore(tmp_path))
    cold_streams, cold_stats = serve(cold)
    assert sorted(cold.programs) == ["decode", "decode_horizon",
                                     "prefill_slot", "verify"]
    with boot_bench.EntryPointCounter() as counter:
        warm = ServingEngine("qwen3-0.6b", EngineConfig(**kw),
                             params=cold.params,
                             store=ProgramStore(tmp_path))
        warm_streams, warm_stats = serve(warm)
    assert counter.calls == 0
    assert {p["source"] for p in
            warm.syscore.report()["programs"].values()} == {"store"}
    assert warm_streams == cold_streams
    assert warm_stats["spec_steps"] == cold_stats["spec_steps"] > 0
    assert warm_stats["horizon_steps"] == cold_stats["horizon_steps"]
