"""The port's dry run (``repro_torch.launch.dryrun``) on the meta device,
every arch x shape at baseline and HQP at decode_32k, held against the JAX
package's dry run cell by cell (``_torch_dryrun_common.check_cell``): the
first four archs of the registry, the CLI, the production meshes'
per-device records and the refusal without a card. The other six are in
``test_torch_dryrun_more.py``."""
import json

import pytest

from _torch_dryrun_common import cells, check_cell, one_thread  # noqa: F401
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.roofline import H100_SXM

ARCHS = configs.list_archs()[:4]


@pytest.mark.parametrize("arch,shape,variant", cells(ARCHS))
def test_cell_matches_reference(arch, shape, variant):
    check_cell(arch, shape, variant)


def test_cli_writes_a_record_a_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "all", "--device", "cpu"])
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert sorted(recs) == sorted(
        f"qwen3-0.6b__{s}__1x1__baseline.json"
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"))
    assert {r["status"] for r in recs.values()} == {"ok", "skipped"}
    assert recs["qwen3-0.6b__decode_32k__1x1__baseline.json"][
        "device"] == "cpu"
    # the hqp tree is served, not trained
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", variant="hqp",
                          device="cpu", save=False)
    assert rec["status"] == "skipped" and "not trained" in rec["reason"]


def test_production_mesh_record_is_per_device():
    one = dryrun.run_cell("granite-3-8b", "decode_32k", "1x1",
                          device="cpu", save=False)
    for mesh, n in (("16x16", 256), ("2x16x16", 512)):
        rec = dryrun.run_cell("granite-3-8b", "decode_32k", mesh,
                              save=False)
        r, mem = rec["roofline"], rec["memory"]
        assert rec["status"] == "ok" and r["chips"] == n
        assert r["hlo_flops_per_device"] is None and r["t_collective"] is None
        assert "sharded execution" in r["null_reason"]
        assert r["model_flops"] == one["roofline"]["model_flops"]
        args = mem["argument_bytes"]
        assert one["memory"]["argument_bytes"] / n <= args < one[
            "memory"]["argument_bytes"] / 16
        assert mem["fits_one_card"] == (args <= H100_SXM.hbm_bytes)


def test_no_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])
