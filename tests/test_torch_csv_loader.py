"""The port's CSV loaders (``bluerov2_dynamics_tpu_torch/data/csv_loader.py``)
against the JAX package's on the same temporary files: the same arrays,
bit for bit (both are host numpy over the same pandas pipeline), and the
same errors.  Mirrors ``tests/test_data.py``'s loader cases."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from bluerov2_dynamics_tpu.data import csv_loader as jcsv  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import csv_loader as tcsv  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _write(path, rng, N=50, inputs=jcsv.THRUSTER_COLS, state=jcsv.EULER12_COLS,
           shuffle=False, with_nan=False, dup=False):
    cols = {"t": np.arange(N) * 0.02}
    for c in state:
        cols[c] = rng.normal(size=N) * 0.4
    for c in inputs:
        cols[c] = np.clip(rng.normal(size=N), -1, 1)
    df = pd.DataFrame(cols)
    if with_nan:
        df.loc[3, state[0]] = np.inf
        df.loc[7, state[6]] = np.nan
    if dup:
        df = pd.concat([df, df.iloc[[5, 9]]])
    if shuffle:
        df = df.sample(frac=1.0, random_state=0)
    df.to_csv(path, index=False)


def _same(a, b):
    for f in ("X", "U", "t"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.dt == b.dt


def test_contracts_and_dataset_match_jax():
    for name in ("EULER12_COLS", "QUAT13_COLS", "THRUSTER_COLS", "WRENCH_COLS"):
        assert getattr(tcsv, name) == getattr(jcsv, name)
    assert tcsv.Dataset._fields == jcsv.Dataset._fields


@pytest.mark.parametrize("kind", ["thruster", "wrench"])
def test_loaders_match_jax_on_dirty_shuffled_csv(kind, tmp_path, rng):
    path = tmp_path / "data.csv"
    inputs = jcsv.THRUSTER_COLS if kind == "thruster" else jcsv.WRENCH_COLS
    _write(path, rng, inputs=inputs, shuffle=True, with_nan=True, dup=True)
    load_j = getattr(jcsv, f"load_{kind}_dataset")
    load_t = getattr(tcsv, f"load_{kind}_dataset")
    want, got = load_j(path, verbose=False), load_t(path, verbose=False)
    _same(got, want)
    assert got.X.shape == (48, 12) and got.U.shape == (48, len(inputs))
    assert np.all(np.diff(got.t) > 0) and got.X.flags.writeable


def test_missing_inputs_are_zero_filled_and_missing_state_raises(tmp_path, rng):
    path = tmp_path / "nostate.csv"
    _write(path, rng, N=20, inputs=())
    _same(tcsv.load_wrench_dataset(path, verbose=False),
          jcsv.load_wrench_dataset(path, verbose=False))
    np.testing.assert_array_equal(tcsv.load_thruster_dataset(path, verbose=False).U, 0.0)
    bad = tmp_path / "noquat.csv"
    _write(bad, rng, N=20, inputs=(), state=[c for c in jcsv.EULER12_COLS
                                            if c not in ("phi", "theta", "psi")])
    for loader in (jcsv.load_quat_dataset, tcsv.load_quat_dataset):
        with pytest.raises(ValueError, match="Missing state column: qw"):
            loader(bad, verbose=False)
    no_t = tmp_path / "no_t.csv"
    pd.read_csv(path).drop(columns="t").to_csv(no_t, index=False)
    for loader in (jcsv.load_thruster_dataset, tcsv.load_thruster_dataset):
        with pytest.raises(ValueError, match="'t' time column"):
            loader(no_t, verbose=False)


@pytest.mark.parametrize("legacy", [True, False])
def test_quat_loader_matches_jax(legacy, tmp_path, rng):
    """A legacy Euler CSV is converted; a quaternion CSV is renormalised."""
    path = tmp_path / "quat.csv"
    if legacy:
        _write(path, rng, N=30, inputs=jcsv.WRENCH_COLS)
    else:
        _write(path, rng, N=30, inputs=jcsv.WRENCH_COLS, state=jcsv.QUAT13_COLS)
    want, got = jcsv.load_quat_dataset(path, verbose=False), tcsv.load_quat_dataset(path, verbose=False)
    _same(got, want)
    np.testing.assert_allclose(np.linalg.norm(got.X[:, 3:7], axis=1), 1.0, atol=1e-12)


def test_parquet_is_read_as_the_csv(tmp_path, rng):
    pytest.importorskip("pyarrow")
    path = tmp_path / "data.csv"
    _write(path, rng)
    pd.read_csv(path).to_parquet(tmp_path / "data.parquet")
    _same(tcsv.load_thruster_dataset(tmp_path / "data.parquet", verbose=False),
          jcsv.load_thruster_dataset(path, verbose=False))


def test_find_latest_csv_and_project_root_match_jax(tmp_path):
    (tmp_path / "rosbags" / "sub").mkdir(parents=True)
    older = tmp_path / "rosbags" / "data.csv"
    newer = tmp_path / "rosbags" / "sub" / "data.csv"
    older.write_text("t\n0\n")
    newer.write_text("t\n0\n")
    now = time.time()
    os.utime(older, (now - 100, now - 100))
    os.utime(newer, (now, now))
    assert tcsv.find_latest_csv(tmp_path, "data.csv") == newer
    assert tcsv.find_project_root(tmp_path / "rosbags" / "sub") == tmp_path
    assert jcsv.find_project_root(tmp_path / "rosbags" / "sub") == tmp_path
    with pytest.raises(FileNotFoundError, match="missing.csv"):
        tcsv.find_latest_csv(tmp_path, "missing.csv")


@pytest.mark.parametrize("overlap", [False, True])
def test_train_test_split_matches_jax(overlap):
    ds = tcsv.Dataset(X=np.arange(101.0)[:, None], U=np.zeros((101, 1)),
                      t=np.arange(101.0), dt=1.0)
    for got, want in zip(tcsv.train_test_split(ds, 0.8, causal_overlap=overlap),
                         jcsv.train_test_split(jcsv.Dataset(*ds), 0.8, causal_overlap=overlap)):
        _same(got, want)


def test_importing_the_loaders_does_not_import_pandas():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "import bluerov2_dynamics_tpu_torch.data.csv_loader\n"
            "print('pandas' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_loaders_run_with_pandas_blocked(tmp_path, rng, monkeypatch):
    """All three column contracts load with ``pandas`` unimportable, and
    give the JAX loaders' arrays (pandas') bit for bit."""
    paths = {"thruster": tmp_path / "u.csv", "wrench": tmp_path / "w.csv",
             "quat": tmp_path / "q.csv", "legacy": tmp_path / "e.csv"}
    _write(paths["thruster"], rng, shuffle=True, with_nan=True, dup=True)
    _write(paths["wrench"], rng, inputs=jcsv.WRENCH_COLS, with_nan=True)
    _write(paths["quat"], rng, inputs=jcsv.WRENCH_COLS, state=jcsv.QUAT13_COLS)
    _write(paths["legacy"], rng, inputs=jcsv.WRENCH_COLS)
    loader = {"thruster": "load_thruster_dataset", "wrench": "load_wrench_dataset",
              "quat": "load_quat_dataset", "legacy": "load_quat_dataset"}
    want = {k: getattr(jcsv, loader[k])(p, verbose=False) for k, p in paths.items()}
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    for k, p in paths.items():
        _same(getattr(tcsv, loader[k])(p, verbose=False), want[k])


def test_values_parse_as_pandas_default_parser_does(tmp_path, rng):
    """pandas' default float converter is not correctly rounded: on
    17-digit values written by ``repr`` it returns another double for a
    large share of them, up to ~1e-12 relative away (measured: 9.8e-13 at
    |x| in [1e-6, 1); bound 2e-12).  The port's reader reproduces that
    converter bit for bit, so its loaders equal the JAX package's."""
    from bluerov2_dynamics_tpu_torch.data import table as tb

    a = rng.normal(size=20000) * 10.0 ** rng.uniform(-8, 4, 20000)
    a[:4] = [0.05029208843735732, -0.0, 1e-320, 123456789012345678.0]
    path = tmp_path / "v.csv"
    path.write_text("a,n\n" + "".join(f"{x!r},{i}\n" for i, x in enumerate(a.tolist())))
    pandas_default = pd.read_csv(path)["a"].to_numpy()
    got = tb.read_csv(path)
    np.testing.assert_array_equal(got["a"].view(np.int64), pandas_default.view(np.int64))
    np.testing.assert_array_equal(got["n"], np.arange(len(a)))
    off = pandas_default != a
    rel = np.abs(pandas_default - a)[off] / np.abs(a[off])
    assert off.mean() > 0.1 and rel.max() < 2e-12
