"""The diagnosis corpus in the port (``repro_torch.perfdbg.corpus``) against
the JAX package's (``repro.perfdbg.corpus``).

The port's module is the reference's but for the package name in its
imports and ``fit_learned``, which keeps the reference's numpy update and
drops its jax branch.  Every other top-level definition keeps the
reference's text; the generated cases are byte-identical; a written corpus
loads back in either package; the port's fit equals the reference's numpy
fit bit for bit, and ``default_learned_strategy`` (which the reference fits
in float32 through jax when jax is importable, as it is here) agrees with
the reference's within rtol 1e-5 and diagnoses every case alike.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.perfdbg import corpus as jcorpus  # noqa: E402
from repro_torch.perfdbg import corpus as tcorpus  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
CORPUS_DIR = REPO / "tests" / "data" / "corpus"
IMPORT = re.compile(r"^(\s*from )repro\.", re.M)
REWRITTEN = {"fit_learned"}
JAX_RTOL = 1e-5


def _nodes(path: Path):
    text = path.read_text()
    return text, ast.parse(text).body


def _key(node):
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return node.name
    return type(node).__name__


def test_every_other_definition_keeps_the_references_text():
    jtext, jbody = _nodes(SRC / "repro" / "perfdbg" / "corpus.py")
    ttext, tbody = _nodes(SRC / "repro_torch" / "perfdbg" / "corpus.py")
    assert len(tbody) == len(jbody)
    # the module docstring (first node) says how the port trains; the rest
    # pairs up node for node
    for jn, tn in zip(jbody[1:], tbody[1:]):
        assert type(tn) is type(jn) and _key(tn) == _key(jn)
        if getattr(tn, "name", None) in REWRITTEN:
            continue
        want = ast.get_source_segment(jtext, jn)
        if isinstance(jn, (ast.Import, ast.ImportFrom)):
            want = IMPORT.sub(r"\1repro_torch.", want)
        assert ast.get_source_segment(ttext, tn) == want, _key(tn)
    fit = next(n for n in tbody if getattr(n, "name", None) == "fit_learned")
    jfit = next(n for n in jbody if getattr(n, "name", None) == "fit_learned")
    assert ast.dump(fit.args) == ast.dump(jfit.args)    # the same signature


@pytest.mark.parametrize("schema", ["paper", "tpu"])
def test_generated_cases_byte_identical(schema):
    j = jcorpus.generate_corpus(seed=3, per_kind=4, n_ranks=8, schema=schema)
    t = tcorpus.generate_corpus(seed=3, per_kind=4, n_ranks=8, schema=schema)
    assert [c.blob for c in t] == [c.blob for c in j]
    assert [c.label for c in t] == [c.label for c in j]
    assert any(c.label["gaps"] for c in t)   # gap-masked cases are among them


def test_write_and_load_round_trip(tmp_path):
    cases = tcorpus.generate_corpus(seed=1, per_kind=2, n_ranks=8)
    manifest = tcorpus.write_corpus(cases, tmp_path / "port")
    assert manifest == jcorpus.write_corpus(
        jcorpus.generate_corpus(seed=1, per_kind=2, n_ranks=8), tmp_path / "ref")
    for d in ("port", "ref"):
        back = tcorpus.load_corpus(tmp_path / d)
        assert [(c.blob, c.label) for c in back] == [(c.blob, c.label) for c in cases]
    ref_back = jcorpus.load_corpus(tmp_path / "port")
    assert [c.blob for c in ref_back] == [c.blob for c in cases]
    (tmp_path / "port" / "case_000.pdws").write_bytes(
        cases[0].blob[:-1] + bytes([cases[0].blob[-1] ^ 1]))
    with pytest.raises(ValueError, match="digest mismatch"):
        tcorpus.load_corpus(tmp_path / "port")


@pytest.fixture(scope="module")
def checked_in():
    return jcorpus.load_corpus(CORPUS_DIR), tcorpus.load_corpus(CORPUS_DIR)


def _model(s):
    return (s.feature_names, s.classes, s.mean, s.std, s.weights, s.bias,
            s.rank_cutoff)


def test_fit_learned_equals_reference_numpy_fit_bit_for_bit(checked_in):
    jcases, tcases = checked_in
    jcal, _ = jcorpus.split_corpus(jcases)
    tcal, _ = tcorpus.split_corpus(tcases)
    ref = jcorpus.fit_learned(jcorpus.labeled_features(jcal), use_jax=False)
    port = tcorpus.fit_learned(tcorpus.labeled_features(tcal))
    for a, b in zip(_model(port), _model(ref)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
    with pytest.raises(ValueError, match="no jax"):
        tcorpus.fit_learned(tcorpus.labeled_features(tcal), use_jax=True)


def test_calibrated_thresholds_identical(checked_in):
    jcases, tcases = checked_in
    j = jcorpus.calibrate_thresholds(jcorpus.labeled_features(jcorpus.split_corpus(jcases)[0]))
    t = tcorpus.calibrate_thresholds(tcorpus.labeled_features(tcorpus.split_corpus(tcases)[0]))
    assert t.cutoffs == j.cutoffs


def _diagnoses(corpus, strategy, cases):
    out = []
    for case in cases:
        d = corpus.case_entry(case, strategy).diagnosis
        out.append((d.kind, d.regions, d.ranks, d.scope, d.confidence))
    return out


def test_default_learned_strategy_matches_the_references_jax_fit(checked_in):
    ref = jcorpus.default_learned_strategy()      # float32, through jax
    port = tcorpus.default_learned_strategy()     # float64 numpy
    # relative to each array's largest entry: float32's absolute error
    # (~1e-7) is above 1e-5 of the smallest weights (~1e-3)
    for got, want in ((port.weights, ref.weights), (port.bias, ref.bias)):
        assert np.abs(got - want).max() <= JAX_RTOL * np.abs(want).max()
    assert port.rank_cutoff == ref.rank_cutoff
    jcases, tcases = checked_in
    generated = tcorpus.generate_corpus(seed=5, per_kind=2)
    for j_cases, t_cases in ((jcases, tcases),
                             (jcorpus.generate_corpus(seed=5, per_kind=2), generated)):
        jd = _diagnoses(jcorpus, ref, j_cases)
        td = _diagnoses(tcorpus, port, t_cases)
        assert [d[:4] for d in td] == [d[:4] for d in jd]
        np.testing.assert_allclose([d[4] for d in td], [d[4] for d in jd],
                                   rtol=JAX_RTOL)
    # the classifier is not trivial: it names more than one kind
    assert len({d[0] for d in td}) > 2
