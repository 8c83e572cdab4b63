"""The port's three-term roofline (``repro_torch.launch.roofline``)
against the JAX package's.

The reference's ``TestRooflineModule`` cases (``tests/test_sharding.py``)
hold against the port's module, with the H100's rates in the record of
``test_cell_roofline_terms`` (989e12 flops and 3.35e12 bytes: one second
each) where the reference's case puts a v5e's.  The reference's
``cell_roofline`` with its three constants set to the H100's gives every
numeric field of the port's row for the same records; the constants are
``perfdbg/attributes.py``'s; the recommendations speak of the card; the
table has one row per counted cell and mesh.
"""
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.perfdbg import attributes  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)


def _record(mode="train", mesh="single", flops=1e15, nbytes=1e12, coll=1e11, **kw):
    rec = {"ok": True, "arch": "yi-34b", "shape": {"train": "train_4k", "prefill":
           "prefill_32k", "decode": "decode_32k"}[mode], "mesh": mesh, "mode": mode,
           "seq_len": 4096, "global_batch": 256, "active_params": 34_000_000_000,
           "total_params": 34_000_000_000,
           "mesh_shape": [2, 16, 16] if mesh == "multi" else [16, 16],
           "hlo_stats": {"flops": flops, "bytes": nbytes, "total_collective_bytes": coll,
                         "collective_bytes": {"all-gather": coll}}}
    rec.update(kw)
    return rec


class TestRooflineModule:
    def test_model_flops_modes(self):
        rec = {"active_params": 1_000, "global_batch": 4, "seq_len": 128,
               "mode": "train"}
        assert roofline.model_flops_global(rec) == 6 * 1000 * 512
        rec["mode"] = "prefill"
        assert roofline.model_flops_global(rec) == 2 * 1000 * 512
        rec["mode"] = "decode"
        assert roofline.model_flops_global(rec) == 2 * 1000 * 4

    def test_cell_roofline_terms(self):
        rec = {"ok": True, "arch": "x", "shape": "train_4k", "mesh": "single",
               "mode": "train", "seq_len": 128, "global_batch": 4,
               "active_params": 1000, "total_params": 1000,
               "mesh_shape": [16, 16],
               "hlo_stats": {"flops": 989e12, "bytes": 3.35e12,
                             "total_collective_bytes": 0.0,
                             "collective_bytes": {}}}
        row = roofline.cell_roofline(rec)
        assert row["compute_s"] == pytest.approx(1.0)
        assert row["memory_s"] == pytest.approx(1.0)
        assert row["dominant"] in ("compute", "memory")
        assert 0 <= row["roofline_fraction"] <= 1.0

    def test_skipped_cells_pass_through(self):
        assert roofline.cell_roofline({"skipped": "reason", "ok": True,
                                       "arch": "x", "shape": "s", "mesh": "m"}) is None


def test_constants_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (attributes.PEAK_FLOPS, attributes.HBM_BW, attributes.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert (jroofline.PEAK_FLOPS, jroofline.HBM_BW, jroofline.LINK_BW) != \
        (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW)


RECORDS = [_record("train"), _record("prefill", flops=1e13, nbytes=1e13, coll=1e9),
           _record("decode", flops=1e11, nbytes=1e12, coll=1e12),
           _record("train", mesh="multi", flops=5e14), _record("decode", coll=0.0)]


@pytest.mark.parametrize("rec", RECORDS)
def test_reference_with_the_cards_constants_gives_every_field(monkeypatch, rec):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, name, getattr(attributes, name))
    ref, port = jroofline.cell_roofline(rec), roofline.cell_roofline(rec)
    assert set(port) == set(ref)
    for key, value in ref.items():
        if key != "recommendation":
            assert port[key] == value, key


def test_recommendations_speak_of_the_card():
    texts = [roofline._recommend(d, {"mode": m}, {}) for d in ("compute", "memory", "collective")
             for m in ("train", "decode")]
    assert not any("MXU" in t or "Pallas" in t or "ICI" in t for t in texts)
    assert "tensor-core" in texts[0] and "K1" in texts[2]


def test_table_has_one_row_per_counted_cell(tmp_path, capsys):
    for i, rec in enumerate(RECORDS + [{"ok": True, "arch": "yi-34b", "shape": "long_500k",
                                        "mesh": "single", "skipped": "skip: ..."}]):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    out = tmp_path.parent / f"{tmp_path.name}_roofline.json"
    assert roofline.main(["--dir", str(tmp_path), "--out", str(out)]) == 0
    text = capsys.readouterr().out
    rows = [line for line in text.splitlines() if line.startswith("| yi-34b")]
    assert len(rows) == len(RECORDS)
    assert text.index("mesh: single") < text.index("mesh: multi")
    table = json.loads(out.read_text())
    assert len(table) == len(RECORDS) + 1 and table[-1]["skipped"]
