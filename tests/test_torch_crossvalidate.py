"""The port's physics gate, tools/crossvalidate.py, against the JAX tool.

The table writer, the --from-json assembly and the point selection are
held against ``schwingermodel_tpu.tools.crossvalidate`` on the same rows
and arguments; one short compare_point runs each sampler the committed
tables use (full-D f64 and the packed refined path) on the CPU; and the
committed port tables, run on the card, are held to their rule: every
point present, no ill configuration, every gated acceptance within its
3 sigma, no |n_sigma_Ep| above 3.5, and sum n_sigma_Ep^2 within the 99%
point of chi^2 with one degree of freedom a row.
"""

import argparse
import json
import os

import numpy as np
import pytest

from schwingermodel_tpu.tools import crossvalidate as jcv
from schwingermodel_tpu_torch.tools import crossvalidate as cv

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _rows(name):
    """A committed JAX table's rows; the older files lack acc_gated, which
    both writers read, so it is filled in from pass_acc."""
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        rows = json.load(f)
    for r in rows:
        r.setdefault("acc_gated", r["pass_acc"] is not None)
    return rows


def _out_args(tmp_path, tag, plaquette_only):
    return argparse.Namespace(
        json=str(tmp_path / f"{tag}.json"), markdown=str(tmp_path / f"{tag}.md"),
        n_sigma=2.0, n_sigma_acc=3.0, plaquette_only=plaquette_only,
        dtype="float32", refine=True, even_odd=False)


@pytest.mark.parametrize("name,plaquette_only", [
    ("crosscheck_f32.json", False), ("crosscheck_f32_tpu_packed.json", True)])
@pytest.mark.parametrize("with_card", [False, True])
def test_table_output_equals_jax(tmp_path, name, plaquette_only, with_card):
    """_write_outputs writes JAX's markdown and JSON; with a card on the
    rows the header line differs from JAX's only by the card's name."""
    rows = _rows(name)
    if with_card:
        rows = [dict(r, backend="cuda", device=CARD) for r in rows]
    ok = all(r["pass_Ep"] for r in rows)
    jcv._write_outputs(_out_args(tmp_path, "jax", plaquette_only), rows, ok)
    cv._write_outputs(_out_args(tmp_path, "port", plaquette_only), rows, ok)
    jax_md = (tmp_path / "jax.md").read_text().splitlines()
    port_md = (tmp_path / "port.md").read_text().splitlines()
    assert len(port_md) == len(jax_md) == 6 + len(rows)
    header = 2
    if with_card:
        assert port_md[header] == jax_md[header].replace(
            "backend=cuda.", f"backend=cuda ({CARD}).")
    else:
        assert port_md[header] == jax_md[header]
    assert [ln for i, ln in enumerate(port_md) if i != header] == [
        ln for i, ln in enumerate(jax_md) if i != header]
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


@pytest.mark.parametrize("names,extra", [
    (["crosscheck_f32.json"], []),
    (["crosscheck_f32_tpu_packed.json"], ["--plaquette-only"]),
    (["crosscheck_f32.json", "crosscheck_f32_tpu_packed.json"], []),
])
@pytest.mark.parametrize("fail_row", [None, 0, 3])
def test_from_json_equals_jax(tmp_path, capsys, names, extra, fail_row):
    """--from-json: the same exit status and verdict line as JAX's, with
    every stored row passing and with one failing."""
    paths = []
    for name in names:
        rows = _rows(name)
        if fail_row is not None:
            rows[fail_row]["pass_Ep"] = False
        p = tmp_path / name
        p.write_text(json.dumps(rows))
        paths.append(str(p))
    out = []
    for tool in (jcv, cv):
        rc = tool.main(["--from-json", *paths, *extra,
                        "--markdown", str(tmp_path / "t.md")])
        out.append((rc, capsys.readouterr().out.strip().splitlines()[-1]))
    assert out[0] == out[1]
    assert out[1] == ((0, "ALL PASS") if fail_row is None
                      else (1, "FAILURES PRESENT"))


@pytest.mark.parametrize("argv", [
    [], ["--lattice", "8"], ["--lattice", "16", "--beta", "2"],
    ["--m0=-0.19"], ["--beta", "4"], ["--lattice", "64"],
    ["--skip", "32:2:-0.19"], ["--skip", "8:2:-0.19:20,16:5:0.2"],
    ["--skip", "8:2:-0.19:10"], ["--lattice", "8", "--skip", "8:1:0.2,8:6:0.2"],
])
def test_point_selection_equals_jax(monkeypatch, capsys, argv):
    """main runs compare_point on the same golden points, in the same
    order, as JAX's main."""
    seen = {}
    for tool, key in ((jcv, "jax"), (cv, "port")):
        calls = seen.setdefault(key, [])

        def fake(ref, args, calls=calls):
            calls.append((ref["Nx"], ref["beta"], ref["m0"], ref["md_steps"]))
            return {"Nx": ref["Nx"], "Nt": ref["Nt"], "beta": ref["beta"],
                    "m0": ref["m0"], "ref_Ep": ref["Ep"], "Ep": ref["Ep"],
                    "n_sigma_Ep": 0.0, "ref_acceptance": ref["acceptance"],
                    "acceptance": ref["acceptance"], "n_sigma_acc": 0.0,
                    "pass_Ep": True, "pass_acc": True, "acc_gated": True}

        monkeypatch.setattr(tool, "compare_point", fake)
    assert jcv.main(argv) == 0
    assert cv.main([*argv, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert seen["port"] == seen["jax"]
    assert seen["port"]


def test_platform_flag_names_device(capsys):
    assert cv.main(["--platform", "cpu"]) == 2
    assert "--device" in capsys.readouterr().err


def _jax_row_keys(monkeypatch, ref, args):
    """The keys of JAX's compare_point row, from a run whose run_hmc is
    stubbed."""
    import schwingermodel_tpu.runner as jrunner

    res = argparse.Namespace(
        Ep=ref["Ep"], dEp=ref["dEp"], acceptance_rate=ref["acceptance"],
        elapsed_seconds=0.0, n_ill=0,
        chains={"plaquette": np.full((16, args.chains), ref["Ep"])})
    monkeypatch.setattr(jrunner, "run_hmc", lambda *a, **k: res)
    return set(jcv.compare_point(ref, args))


@pytest.mark.parametrize("mode", ["fulld_f64", "packed_refined"])
def test_compare_point_runs_on_cpu(monkeypatch, tmp_path, mode):
    """One short compare_point at 8x8 beta=2 m0=0.2 on each sampler of the
    committed tables (the unpacked full-D f64 one and the packed refined
    one, here on the kernels' plain twins): JAX's keys plus device, every
    number finite, the acceptance ungated under --plaquette-only."""
    monkeypatch.chdir(tmp_path)
    with open(jcv.GOLDEN_DEFAULT) as f:
        ref = next(r for r in json.load(f)
                   if (r["Nx"], r["beta"], r["m0"]) == (8, 2.0, 0.2))
    ref = dict(ref, ntherm=2)
    packed = mode == "packed_refined"
    args = argparse.Namespace(
        device="cpu", dtype="float32" if packed else "float64", refine=packed,
        even_odd=packed, plaquette_only=packed, nmeas=6, chains=2, seed=11,
        md_steps=None, integrator="leapfrog", hasenbusch_dm=None,
        n_sigma=2.0, n_sigma_acc=3.0)
    row = cv.compare_point(ref, args)
    assert set(row) == _jax_row_keys(monkeypatch, ref, args) | {"device"}
    assert row["backend"] == row["device"] == "cpu"
    assert row["n_ill"] == 0 and row["nmeas"] == 6 and row["chains"] == 2
    assert all(np.isfinite(v) for v in row.values() if isinstance(v, float))
    if packed:
        assert row["pass_acc"] is None and row["acc_gated"] is False
    else:
        assert row["pass_acc"] in (True, False) and row["acc_gated"] is True
    assert os.listdir(tmp_path) == []


# ---------- the committed tables ----------

def _golden_points():
    with open(jcv.GOLDEN_DEFAULT) as f:
        return [(r["Nx"], r["beta"], r["m0"]) for r in json.load(f)]


# chi^2 with one degree of freedom a row, 99% point
CHI2_99 = {16: 32.00, 14: 29.14}
TABLES = {
    "crosscheck_torch_f32_packed.json":
        [p for p in _golden_points() if p != (32, 2.0, -0.19)],
    "crosscheck_torch_f64_fulld.json":
        [p for p in _golden_points() if p[0] in (8, 16)],
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_committed_port_table_passes(name):
    """A table run on the card holds to the rule fixed before its run:
    every point, no ill configuration, every gated acceptance passing
    JAX's 3 sigma gate, no |n_sigma_Ep| above 3.5, and sum n_sigma_Ep^2
    under the 99% point of chi^2 with a degree of freedom a row."""
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        rows = json.load(f)
    for r in rows:
        assert r["backend"] == "cuda" and "H100" in r["device"]
        assert r["device"].endswith(" W"), r["device"]
    assert [r for r in rows if r["n_ill"]] == []
    assert [r for r in rows if r["acc_gated"] and not r["pass_acc"]] == []
    assert max(abs(r["n_sigma_Ep"]) for r in rows) <= 3.5
    want = TABLES[name]
    assert sorted((r["Nx"], r["beta"], r["m0"]) for r in rows) == sorted(want)
    assert sum(r["n_sigma_Ep"] ** 2 for r in rows) <= CHI2_99[len(want)]
