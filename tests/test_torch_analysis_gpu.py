"""The cost meter and the analysis passes on the card (marker ``gpu``), at
smoke width, float32:

  * each generate branch of the qwen3 (dense and paged) and deepseek-v2
    (dense) smoke engines, metered eagerly on the card, counts the FLOPs
    and bytes the CPU's ``FakeTensorMode`` count gives, bit for bit, and
    the meter prices exactly the kernel launches the wrappers count;
  * a speculative window's branches do the same;
  * the five passes find nothing on a dense and a paged qwen3 cell on the
    card (the sync monitor in ``set_sync_debug_mode("error")``).

Without a CUDA device every test here skips (decided inside the ``cuda``
fixture, so every worker collects the same tests). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_analysis_gpu.py

(``--noconftest``: tests/conftest.py manages JAX, which the card's machine
does not have; this file imports no JAX.)
"""

import dataclasses

import pytest
import torch

from repro_torch.analysis import cost
from repro_torch.configs import deepseek_v2_236b as PDS
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

CONFIGS = {"gqa": PQ, "mla": PDS}
LAYOUTS = {"dense": {}, "paged": {"paged": True, "page_size": 8},
           "dense-spec": {"speculate": 2}}
# the paged MLA read has no instantiation at the smoke latent (24); the
# dense MLA step runs no kernel, its plain read on every device
CASES = [(a, lay) for a in CONFIGS for lay in LAYOUTS
         if (a, lay) != ("mla", "paged")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("arch,layout", CASES)
def test_card_count_equals_fake_count(cuda, arch, layout):
    cfg = dataclasses.replace(CONFIGS[arch].smoke_config(soi="pp"),
                              dtype="float32")
    kw = dict(max_concurrent_decodes=2, max_len=32, **LAYOUTS[layout])
    params = T.init(cfg, generator=torch.Generator(device=cuda)
                    .manual_seed(0), device=cuda)
    step = "speculative_window" if "speculate" in kw else "generate"
    card = cost.measure_engine(cfg, kw, params=params, device=cuda,
                               names=(step,))[step]
    fake = cost.measure_engine(cfg, kw, fake=True, names=(step,))[step]
    assert card.to_metrics() == fake.to_metrics()
    assert card.peak_bytes is not None and fake.peak_bytes is None
    assert card.flops > card.flops_min

    from repro_torch.engine.soi_engine import SOIEngine
    engine = SOIEngine(cfg, device=cuda, **kw)
    entry = next(e for e in engine.analysis_entries(params)
                 if e.name == step)
    for branch in entry.branches:
        ops.reset_launch_counts()
        m, _ = cost.meter_call(entry.fn, entry.with_branch(branch))
        launched = {k: n for k, n in ops.launch_counts().items() if n}
        assert launched == dict(m.kernels)
        assert m.unpriced_kernels == []


@pytest.mark.parametrize("name", ["gqa-dense", "gqa-paged"])
def test_passes_clean_on_card(cuda, name):
    from repro_torch.analysis import analyze
    report = analyze([name], device=cuda, baseline_path=False)
    assert report.findings == [], report.render()
