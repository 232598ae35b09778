"""The port's headline benchmark (``vq_tpu_torch/bench/headline.py``, the
counterpart of the root ``bench.py``) and its corpus makers
(``vq_tpu_torch/bench/corpora.py``), on the CPU at ``--smoke`` sizes.

* the full record has exactly ``BENCH_SELF.json``'s keys (the JAX
  package's committed record) plus ``errors`` and the card's two fields;
* each section runs on its own: one that raises lands in ``errors``, the
  others still report, the compact line is printed and the exit code is 1;
  a gate under its floor and a false exactness assert exit 1 too;
* ``vs_baseline`` = QPS·N / 2.4e6;
* each corpus maker has its ``bench.py`` definition's σ profile and
  neighbourhood structure, within the sampling tolerances stated at each
  test (relative errors ~1/√(2n) for a column's standard deviation).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vq_tpu_torch.bench import corpora, headline

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CARD_FIELDS = {"card_name", "card_power_limit"}


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One ``--smoke --device cpu`` run: (exit code, record, stdout lines)."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("headline") / "record.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = headline.main(["--smoke", "--device", "cpu", "--out", str(out)])
    return rc, json.loads(out.read_text()), buf.getvalue().strip().splitlines()


def test_smoke_record_has_every_bench_self_key(smoke):
    rc, rec, lines = smoke
    assert rc == 0 and rec["errors"] == {}
    want = set(json.loads((ROOT / "BENCH_SELF.json").read_text()))
    assert len(want) == 172
    assert set(rec) == want | {"errors"} | CARD_FIELDS
    assert rec["card_name"] is None and rec["card_power_limit"] is None  # no card here
    assert rec["assert_ok"] is True and rec["assert_compiled"] is False  # plain on the CPU
    compact = json.loads(lines[-1])
    assert set(compact) == set(headline.COMPACT_KEYS) | {"errors", "full_results"} | CARD_FIELDS


def test_vs_baseline_is_qps_times_n_over_the_reference_rate(smoke):
    _, rec, _ = smoke
    assert rec["vs_baseline"] == pytest.approx(rec["value"] * rec["n"] / 2.4e6, rel=1e-12)
    assert rec["value"] >= rec["value_median"] > 0 and 0 <= rec["value_spread"] < 1


def fake_sections(monkeypatch, **overrides):
    """Every section replaced by one that writes a field of its own (or by
    ``overrides[name]``); returns the names each wrote."""
    wrote = {}
    for name in headline.SECTIONS:
        def section(out, run, name=name):
            out[f"{name}_ran"] = True
        monkeypatch.setattr(headline, name, overrides.get(name, section))
        wrote[name] = f"{name}_ran"
    return wrote


def good_gate(out, run):
    out["recall_gate_pq192"] = 0.9
    out["recall_gate_floor"] = headline.RECALL_GATE_PQ192_FLOOR


def good_assert(out, run):
    out["assert_ok"] = True
    out["assert_compiled"] = False


def run_main(tmp_path, capsys):
    rc = headline.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "r.json")])
    rec = json.loads((tmp_path / "r.json").read_text())
    return rc, rec, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_section_that_raises_is_recorded_and_the_others_still_report(monkeypatch, tmp_path,
                                                                       capsys):
    """The real sections at --smoke sizes, one of them forced to raise."""
    def broken(out, run):
        raise RuntimeError("out of memory at N=1,048,576")

    monkeypatch.setattr(headline, "packed_saq_1m", broken)
    rc, rec, compact = run_main(tmp_path, capsys)
    assert rc == 1
    assert rec["errors"] == {"packed_saq_1m": "RuntimeError: out of memory at N=1,048,576"}
    assert compact["errors"] == rec["errors"] and compact["assert_ok"] is True
    assert "saq_packed_qps" not in rec and "saq_packed_qps" not in compact
    for field in ("value", "recall_gate_pq192", "assert_ok", "rabitq_packed_qps",
                  "ivf_coarse_s", "ivfpk_bs256_np200_g16_qps"):  # before and after it
        assert field in rec


@pytest.mark.parametrize("case", ["gate under its floor", "assert false", "no gate"])
def test_a_failed_gate_or_assert_exits_1(monkeypatch, tmp_path, capsys, case):
    def low_gate(out, run):
        good_gate(out, run)
        out["recall_gate_pq192"] = headline.RECALL_GATE_PQ192_FLOOR - 1e-4

    def bad_assert(out, run):
        out.update(assert_ok=False, assert_compiled=False, assert_detail="pq/table:False")

    overrides = {"gate under its floor": dict(recall_gate_pq192=low_gate,
                                              exactness_assert=good_assert),
                 "assert false": dict(recall_gate_pq192=good_gate, exactness_assert=bad_assert),
                 "no gate": dict(exactness_assert=good_assert)}[case]
    fake_sections(monkeypatch, **overrides)
    rc, rec, _ = run_main(tmp_path, capsys)
    assert rc == 1 and rec["errors"] == {}


def test_every_section_passing_exits_0(monkeypatch, tmp_path, capsys):
    fake_sections(monkeypatch, recall_gate_pq192=good_gate, exactness_assert=good_assert)
    rc, rec, _ = run_main(tmp_path, capsys)
    assert rc == 0 and rec["errors"] == {}


def test_no_card_raises_before_any_work(monkeypatch, tmp_path):
    fake_sections(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        headline.main(["--smoke", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


# ------------------------------------------------------------------ corpora
N, DIM, NQ = 20_000, 48, 64


def scaled_nearest(x, q, sigma):
    """Per query: (index of, and mean squared σ-scaled distance per dim to)
    its nearest row in σ-scaled coordinates."""
    d2 = torch.cdist(q / sigma, x / sigma) ** 2 / x.shape[1]
    v, i = d2.min(dim=1)
    return i, v


@pytest.mark.parametrize("maker,power,jitter", [("powerlaw", 0.75, 0.25),
                                                 ("packed_corpus", 0.6, 0.1)])
def test_powerlaw_corpora_have_bench_sigma_profile_and_jittered_queries(maker, power, jitter):
    """bench.py:79-88 (σ_i = (1+i)^-0.75, queries rows + 0.25σ) and :261-275
    (σ_i = (1+i)^-0.6, rows + 0.1σ).  Column standard deviations within
    4% of σ (sampling error ~0.5% at N=20,000); a query's nearest row in
    σ-scaled coordinates lies at a squared distance a dim of jitter² · χ²₄₈
    / 48: its mean over 64 queries within 10% of jitter² (its sampling
    error 2.5%), each one below 0.5, far from the 2 of independent rows."""
    x, q = getattr(corpora, maker)(N, DIM, NQ, seed=3, device="cpu")[:2]
    sigma = (1.0 + torch.arange(DIM, dtype=torch.float32)) ** -power
    np.testing.assert_allclose(x.std(dim=0).numpy(), sigma.numpy(), rtol=0.04)
    _, v = scaled_nearest(x, q, sigma)
    assert float(v.mean()) == pytest.approx(jitter ** 2, rel=0.1) and float(v.max()) < 0.5


def test_packed_corpus_lognormal_scales_rows_by_exp_half_normal():
    """bench.py:320-341: the same rows times exp(0.5·N(0, 1)): the log of
    each row's scale has a standard deviation of 0.5 (within 3%: its
    sampling error at N=20,000 is 0.5%)."""
    x, _, sigma = corpora.packed_corpus(N, DIM, NQ, seed=4, device="cpu", lognormal=True)
    base, _, _ = corpora.packed_corpus(N, DIM, NQ, seed=4, device="cpu")
    log_scale = torch.log(torch.linalg.norm(x, dim=1) / torch.linalg.norm(base, dim=1))
    assert float(log_scale.std()) == pytest.approx(0.5, rel=0.03)
    assert abs(float(log_scale.mean())) < 0.02
    assert torch.equal(sigma, (1.0 + torch.arange(DIM, dtype=torch.float32)) ** -0.6)


def neighbour_ratio(x, kc):
    """Mean squared distance of rows i and i + kc (one centre) over that of
    rows i and i + 1 (different centres)."""
    same = ((x[:-kc] - x[kc:]) ** 2).sum(1).mean()
    other = ((x[:-1] - x[1:]) ** 2).sum(1).mean()
    return float(same / other)


def test_planted_corpus_is_a_rank_32_manifold_of_10_row_neighbourhoods():
    """bench.py:196-215: rank 32 in D, unit rows, row i shares its centre
    with row i + N/10 (within-document spread 0.5 against centres N(0, 1):
    a same-centre pair lies at ~0.2 of a different pair's squared distance;
    < 0.35 allows the sampling and the normalization)."""
    n, d = 5000, 96
    x, q = corpora.planted(n, d, NQ, seed=5, device="cpu")
    s = torch.linalg.svdvals(x)
    assert float(s[31] / s[0]) > 1e-3 and float(s[32] / s[0]) < 1e-5
    np.testing.assert_allclose(torch.linalg.norm(x, dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(q, dim=1).numpy(), 1.0, rtol=1e-5)
    assert neighbour_ratio(x, n // 10) < 0.35


def test_fullrank_corpus_is_full_rank_with_100_row_neighbourhoods():
    """bench.py:441-475: full rank (rank = D), unit rows, row i shares its
    centre with row i + N/100 (spread 1.0 against centres N(0, 1): a
    same-centre pair at ~0.5 of a different pair's squared distance;
    < 0.65), made block by block, the same rows from the same seed."""
    n, d = 6400, 64
    x, q = corpora.fullrank(n, d, NQ, seed=11, device="cpu", block=1000)
    s = torch.linalg.svdvals(x)
    assert float(s[-1] / s[0]) > 1e-4  # a rank-deficient x: ~1e-7
    np.testing.assert_allclose(torch.linalg.norm(x, dim=1).numpy(), 1.0, rtol=1e-5)
    assert neighbour_ratio(x, n // 100) < 0.65
    x2, q2 = corpora.fullrank(n, d, NQ, seed=11, device="cpu", block=1000)
    assert torch.equal(x, x2) and torch.equal(q, q2)


def test_corpus_makers_go_to_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for maker in (corpora.powerlaw, corpora.planted, corpora.packed_corpus, corpora.fullrank):
        with pytest.raises(RuntimeError, match="cuda"):
            maker(200, 8, 4, seed=0)
        assert maker(200, 8, 4, seed=0, device="cpu")[0].device.type == "cpu"


def test_the_benchmark_modules_import_no_jax():
    """headline.py, scan53m.py and entry.py, imported and run on the CPU in
    a fresh interpreter, load nothing of JAX or of the JAX package."""
    import subprocess
    import sys

    prog = (
        "import contextlib, io, sys\n"
        "from vq_tpu_torch.bench import headline, scan53m\n"
        "from vq_tpu_torch.entry import entry\n"
        "fn, args = entry('cpu'); fn(*args)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert scan53m.main(['--n', '3000', '--chunk', '1024', '--q', '8', '--method',"
        " 'saq', '--device', 'cpu']) == 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vq_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
