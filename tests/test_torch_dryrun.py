"""The port's dry run (``python -m repro_torch.launch.dryrun``): no card,
no process group.

  * qwen3-1.7b through ``main()`` on both production meshes: every
    runnable cell ``ok`` (long_500k skipped, as the reference skips it for
    a full-attention arch), one JSON a cell, the reference's microbatch
    count, and the bytes a device holds of params, AdamW state and decode
    state equal to the reference's layouts (``test_torch_sharding``);
  * ``make_production_mesh`` without enough ranks raises, pointing to the
    dry run;
  * ``--all --mesh both``: every cell of the 10 LM archs lays out with no
    error (~10 s on one worker).
"""

import json

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from test_torch_sharding import _ref_layout, _ref_state_bytes

torch.set_num_threads(1)


def test_one_arch_on_both_meshes(tmp_path):
    out = tmp_path / "dr"
    recs = dryrun.main(["--arch", "qwen3-1.7b", "--mesh", "both",
                        "--out", str(out)])
    assert len(recs) == 8 and len(list(out.glob("*.json"))) == 8
    by = {(r["shape"], r["mesh"]): r for r in recs}
    for (shape, mesh), rec in by.items():
        saved = json.loads((out / f"qwen3-1.7b_{shape}_"
                            f"{'multi' if mesh == '2x16x16' else 'single'}"
                            f".json").read_text())
        assert saved["status"] == rec["status"]
        if shape == "long_500k":
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok" and rec["fits"]
        multi = mesh == "2x16x16"
        _, notes, param_bytes, _ = _ref_layout("qwen3-1.7b", multi)
        b = rec["per_device_bytes"]
        assert b["params"] == param_bytes
        assert rec["sharding_notes"] == notes[:20]
        assert b["total"] == sum(v for k, v in b.items() if k != "total")
        if shape == "train_4k":
            assert b["opt"] == 2 * param_bytes + 4
            # 256 rows, 4 a device a microbatch: 256 // (16 x 4) or
            # 256 // (32 x 4)
            assert rec["microbatches"] == (2 if multi else 4)
        if shape == "decode_32k":
            want, _ = _ref_state_bytes("qwen3-1.7b", multi)
            assert b["decode_state"] == sum(want.values())


def test_production_mesh_without_ranks_points_to_the_dry_run():
    with pytest.raises(RuntimeError, match="repro_torch.launch.dryrun"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_all_cells_lay_out(tmp_path, capsys):
    recs = dryrun.main(["--all", "--mesh", "both", "--out",
                        str(tmp_path)])
    status = [r["status"] for r in recs]
    assert status.count("error") == 0
    assert status.count("ok") == 66 and status.count("skipped") == 14
    assert "dry-run: 66 ok, 14 skipped (documented), 0 errors" in \
        capsys.readouterr().out


@pytest.mark.parametrize("policy", [None, "dots", "names", "none"])
def test_remat_override_reaches_the_config_and_the_record(
        tmp_path, monkeypatch, policy):
    """``--remat`` as the reference's dry run takes it: the cells' config
    runs with that ``remat_policy`` (the default ``"full"`` without it),
    and every record carries it."""
    seen = []
    param_specs = dryrun.S.param_specs

    def spy(cfg, *args, **kw):
        seen.append(cfg.remat_policy)
        return param_specs(cfg, *args, **kw)
    monkeypatch.setattr(dryrun.S, "param_specs", spy)
    argv = ["--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh", "both",
            "--out", str(tmp_path)]
    recs = dryrun.main(argv + (["--remat", policy] if policy else []))
    want = policy or "full"
    assert seen == [want, want]
    assert [r["remat_policy"] for r in recs] == [want, want]
    for f in tmp_path.glob("*.json"):
        assert json.loads(f.read_text())["remat_policy"] == want
    # the layout does not depend on the policy; an unknown one is refused
    assert all(r["status"] == "ok" for r in recs)
    with pytest.raises(SystemExit):
        dryrun.main(argv + ["--remat", "some"])
