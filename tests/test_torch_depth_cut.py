"""A serving engine cut in depth (``EngineConfig.n_layers``), on the CPU.

A measurement may serve a model at its published width and fewer layers
(``chip_smoke.py`` runs its program-store and fleet phases so, to keep
inside its time).  The cut engine's config, weights and program
fingerprints follow the depth, its streams equal its own
``reference_generate``, and the boot bench (``bench.boot --layers``)
boots it cold and then warm from one store."""
import numpy as np
import pytest

from repro_torch.bench import boot as boot_bench
from repro_torch.engine_config import EngineConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import transformer

ARCH = "qwen3-0.6b"


def test_n_layers_is_checked_and_round_trips():
    with pytest.raises(ValueError, match="n_layers"):
        EngineConfig(n_layers=0)
    cfg = EngineConfig(n_layers=3)
    assert EngineConfig.from_dict(cfg.to_dict()) == cfg
    assert EngineConfig().n_layers is None


def test_engine_cut_in_depth_serves_its_first_layers():
    kw = dict(device="cpu", batch=2, max_len=32, clock="step")
    full = ServingEngine(ARCH, EngineConfig(**kw))
    cut = ServingEngine(ARCH, EngineConfig(n_layers=1, **kw))
    assert full.cfg.n_layers == 2 and cut.cfg.n_layers == 1
    assert cut.cfg == full.cfg.replace(n_layers=1)
    unit, n_groups, tail = transformer.split_layers(cut.cfg)
    assert n_groups + len(tail) == 1
    # the weights' stacked layer axis and the programs follow the depth
    wq = cut.params["groups"]["slot0"]["mix"]["wq"]
    assert wq.shape[0] == 1
    assert all(cut.programs[k].program.fingerprint !=
               full.programs[k].program.fingerprint for k in cut.programs)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cut.cfg.vocab_size, size=n) for n in (6, 11)]
    reqs = [cut.submit(p, max_new=5) for p in prompts]
    cut.run()
    assert [r.generated for r in reqs] == \
        [cut.reference_generate(p, 5) for p in prompts]


def test_boot_bench_boots_a_cut_model_cold_then_warm(tmp_path):
    kw = dict(full=False, device="cpu", batch=2, max_len=32,
              prompt_lens=(5, 9), max_new=4, n_layers=1)
    _, cold = boot_bench.run_boot(ARCH, tmp_path, **kw)
    _, warm = boot_bench.run_boot(ARCH, tmp_path, **kw)
    assert cold["n_layers"] == warm["n_layers"] == 1
    assert cold["store"]["puts"] == len(cold["programs"])
    assert all(p["source"] == "store" for p in warm["programs"].values())
    assert warm["python_calls"]["boot_and_serve"] == 0
    assert warm["tokens"] == cold["tokens"]
