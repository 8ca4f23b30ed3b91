"""The port's linear probe (`madeleine_torch/eval/linear_probe.py`) and its
two probing CLIs on the CPU against the JAX package's probe and sklearn:
the folds' splits equal JAX's `load_and_split` exactly; the solver against
`LogisticRegression(C=1, tol=1e-10)` at 1e-6 absolute on probabilities and
1e-5 relative on coefficients; the metrics against sklearn's at 1e-12;
`eval_single_task` against JAX's within 1e-4 with the pickles' layout
equal."""

import csv
import os
import pickle
import shutil
import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import balanced_accuracy_score as sk_bacc
from sklearn.metrics import cohen_kappa_score
from sklearn.metrics import roc_auc_score as sk_auc

from madeleine_tpu.data.io import list_bags as jax_list_bags
from madeleine_tpu.data.io import load_features as jax_load_features
from madeleine_tpu.eval import linear_probe as jax_lp
from madeleine_tpu.data.io import write_bag
from madeleine_tpu.native.bagio import write_bag_file
from madeleine_tpu.utils.seed import set_deterministic_mode as jax_seed
from madeleine_torch.cli import extract_mean_embs, run_linear_probing
from madeleine_torch.eval import linear_probe as lp
from madeleine_torch.utils.file_utils import load_pkl, save_pkl
from madeleine_torch.utils.seed import set_deterministic_mode

N_SLIDES, DIM = 64, 24


def _cohort(root, name="cohort.csv", tasks=("er", "isup_grade"), seed=0):
    """A label CSV of N_SLIDES slides (binary `er` with some -1, 3-class
    `isup_grade`; BCNB's columns when tasks are er/pr/her2) and an embeddings
    pkl holding most of those slides plus some the CSV lacks, each shifted
    along one direction by its labels."""
    rng = np.random.default_rng(seed)
    ids = [str(100 + i) for i in range(N_SLIDES)]
    labels = {}
    for t in tasks:
        n_cls = 3 if t == "isup_grade" else 2
        y = rng.integers(0, n_cls, N_SLIDES)
        y[rng.random(N_SLIDES) < 0.1] = -1
        labels[t] = y
    os.makedirs(root, exist_ok=True)
    csv_path = os.path.join(root, name)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "slide_id", *tasks])
        for i, sid in enumerate(ids):
            w.writerow([i, sid, *(int(labels[t][i]) for t in tasks)])
    kept = [i for i in range(N_SLIDES) if i % 9 != 4]
    emb_ids = [ids[i] for i in kept] + ["9001", "9002"]
    shift = sum(np.maximum(labels[t], 0)[kept] * (j + 1.0) for j, t in enumerate(tasks))
    emb = rng.standard_normal((len(emb_ids), DIM)).astype(np.float32)
    emb[:len(kept), 0] += 0.8 * shift
    pkl = os.path.join(root, "madeleine_slide_embeddings.pkl")
    save_pkl(pkl, {"embeds": emb, "slide_ids": emb_ids})
    return csv_path, pkl


def _jax_labels(csv_path, task):
    labels = pd.read_csv(csv_path)
    labels["slide_id"] = labels["slide_id"].astype(str)
    return labels[labels[task] != -1][["slide_id", task]]


@pytest.mark.parametrize("normalize", [False, True])
def test_split_equals_jax_fold_by_fold(tmp_path, normalize):
    csv_path, pkl = _cohort(str(tmp_path))
    if normalize:   # a constant column: sklearn's zero-variance rule
        obj = load_pkl(pkl)
        obj["embeds"][:, 3] = 2.5
        save_pkl(pkl, obj)
    for task in ("er", "isup_grade"):
        labels = lp.read_labels(csv_path, task)
        for k in (1, 10, 25):
            for fold in range(3):
                jax_seed(fold)
                try:
                    want = jax_lp.load_and_split(_jax_labels(csv_path, task), pkl, task, k,
                                                 normalize=normalize)
                except ValueError:   # every slide drawn, no test set: both raise
                    want = None
                set_deterministic_mode(fold)
                if want is None:
                    with pytest.raises(ValueError):
                        lp.load_and_split(labels, pkl, task, k, normalize=normalize)
                    continue
                got = lp.load_and_split(labels, pkl, task, k, normalize=normalize)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    if normalize and g.dtype == np.float32:
                        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
                    else:
                        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_solver_against_sklearn(n_classes):
    rng = np.random.default_rng(n_classes)
    n, d = 40, 24
    y = rng.integers(0, n_classes, n) * 2 + 1     # labels 1, 3(, 5): classes_ order
    x = rng.standard_normal((n, d)) + 0.4 * y[:, None]
    x_test = rng.standard_normal((50, d)) + 1.0
    got = lp.L2LogisticRegression(C=1.0, device="cpu").fit(x, y)
    want = LogisticRegression(C=1, tol=1e-10, max_iter=10000).fit(x, y)
    np.testing.assert_array_equal(got.classes_, want.classes_)
    np.testing.assert_allclose(got.predict_proba(x_test), want.predict_proba(x_test),
                               rtol=0, atol=1e-6)
    for g, w in ((got.coef_, want.coef_), (got.intercept_, want.intercept_)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(want.coef_).max())
    np.testing.assert_array_equal(got.predict(x_test), want.predict(x_test))
    if n_classes > 2:   # the softmax intercepts sum to zero, as lbfgs leaves them
        assert abs(got.intercept_.sum()) < 1e-12


def test_solver_refuses_one_class():
    with pytest.raises(ValueError, match="one class"):
        lp.L2LogisticRegression(device="cpu").fit(np.ones((3, 2)), [1, 1, 1])


def test_metrics_against_sklearn():
    rng = np.random.default_rng(0)
    y2 = rng.integers(0, 2, 60)
    s = np.round(rng.random(60), 1)               # many tied scores
    assert lp.roc_auc_score(y2, s) == pytest.approx(sk_auc(y2, s), abs=1e-12)
    y02 = y2 * 2                                  # labels {0, 2}: the larger is positive
    assert lp.roc_auc_score(y02, s) == pytest.approx(sk_auc(y02, s), abs=1e-12)

    y3 = rng.integers(0, 3, 60)
    p3 = np.round(rng.dirichlet(np.ones(3), 60), 2)
    p3[:, 2] = 1 - p3[:, 0] - p3[:, 1]
    assert lp.roc_auc_score(y3, p3) == pytest.approx(
        sk_auc(y3, p3, multi_class="ovr", average="macro"), abs=1e-12)
    pred = rng.integers(0, 3, 60)
    yt, pt, ps = y3, pred, p3
    assert lp.calculate_metrics(yt, pt, ps) == pytest.approx(
        (sk_auc(yt, ps, multi_class="ovr", average="macro"), sk_bacc(yt, pt)), abs=1e-12)

    # the train set lacked a class that the test labels hold: 2-column
    # scores against 3 classes, where sklearn raises
    p2 = np.stack([1 - p3[:, 0], p3[:, 0]], axis=1)
    with pytest.raises(ValueError, match="Number of classes"):
        sk_auc(y3, p2, multi_class="ovr")
    with pytest.raises(ValueError, match="Number of classes"):
        lp.calculate_metrics(y3, pred, p2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert np.isnan(sk_auc(np.ones(5), s[:5])) and np.isnan(lp.roc_auc_score(np.ones(5), s[:5]))

        # balanced accuracy with a predicted class absent from y_true
        yb, pb = np.array([0, 0, 1, 1, 1]), np.array([0, 2, 1, 2, 1])
        assert lp.balanced_accuracy_score(yb, pb) == pytest.approx(sk_bacc(yb, pb), abs=1e-12)
        assert lp.balanced_accuracy_score(y3, pred) == pytest.approx(sk_bacc(y3, pred),
                                                                     abs=1e-12)

        for a, b in ((y3, pred), (np.array([0, 1, 5, 5]), np.array([0, 5, 5, 3])),
                     (np.array([2, 2, 2]), np.array([2, 2, 2]))):
            want = cohen_kappa_score(a, b, weights="quadratic")
            got = lp.quadratic_kappa(a, b)
            assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, abs=1e-12)


def _stores(root, m_name="madeleine_slide_embeddings"):
    d = os.path.join(root, "res_linear_probing", m_name)
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = pickle.load(f)
    return out


def test_eval_single_task_matches_jax(tmp_path):
    csv_path, pkl = _cohort(str(tmp_path / "jax"))
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    port_pkl = str(port_dir / os.path.basename(pkl))
    shutil.copy(pkl, port_pkl)
    tasks, ks = ["er", "isup_grade"], (1, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_lp.eval_single_task(pkl, csv_path, tasks, ks=ks, num_folds=3, verbose=False)
        record = []
        got = lp.eval_single_task(port_pkl, csv_path, tasks, ks=ks, num_folds=3, verbose=False,
                                  device="cpu", record=record)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys()
        for m in want[key]:
            assert len(got[key][m]) == len(want[key][m]), (key, m)
            np.testing.assert_allclose(got[key][m], want[key][m], rtol=0, atol=1e-4,
                                       err_msg=f"{key} {m}")
    assert sum(len(v["bacc"]) for v in got.values()) == len(record) == 12
    assert _stores(str(port_dir)).keys() == _stores(str(tmp_path / "jax")).keys()
    for fn, store in _stores(str(port_dir)).items():
        assert store.keys() == {"tangle"} and store["tangle"].keys() == {"auc", "bacc", "q_kappa"}
        np.testing.assert_equal(store["tangle"],
                                got[(int(fn[2:fn.index("_")]), fn.split("_probing_")[1][:-7])])


def test_probing_cli_in_process(tmp_path, monkeypatch):
    """run_linear_probing with --device cpu on a BCNB.csv (tasks from the
    name): the full protocol, 3 k x 3 tasks x 10 folds, a pickle per (k,
    task) holding the sweep's store; without --device it refuses a machine
    with no card."""
    csv_path, pkl = _cohort(str(tmp_path / "cli"), name="BCNB.csv", tasks=("er", "pr", "her2"))
    argv = ["--slide_embedding_pkl", pkl, "--label_path", csv_path]
    record = []
    metrics = run_linear_probing.main(argv + ["--device", "cpu"], record=record)
    assert set(metrics) == {(k, t) for k in lp.ALL_K for t in lp.BCNB_BREAST_TASKS}
    assert len(record) == sum(len(v["auc"]) for v in metrics.values())
    stores = _stores(str(tmp_path / "cli"))
    assert sorted(stores) == sorted(f"k={k}_probing_{t}.pickle" for k in lp.ALL_K
                                    for t in lp.BCNB_BREAST_TASKS)
    for (k, t), store in metrics.items():   # NaN where a fold's test set has one class
        assert len(store["auc"]) == len(store["bacc"]) > 0 and store["q_kappa"] == []
        np.testing.assert_equal(stores[f"k={k}_probing_{t}.pickle"], {"tangle": store})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_linear_probing.main(argv)


def test_mean_embs_cli_in_process(tmp_path):
    """extract_mean_embs with --device cpu over .npz and .bag bags: the pkl's
    schema, ids and means those of the JAX script's reading (its
    list_bags / load_features and numpy's mean) within 1e-6."""
    bag_dir = tmp_path / "cohort" / "patch_embeddings"
    rng = np.random.default_rng(5)
    for i, n in enumerate((37, 300, 1, 1000)):
        feats = rng.standard_normal((n, 16)).astype(np.float32)
        if i % 2:
            os.makedirs(bag_dir, exist_ok=True)
            write_bag_file(str(bag_dir / f"slide_{i}.bag"), feats)
        else:
            write_bag(str(bag_dir / f"slide_{i}.npz"), feats)
    out = extract_mean_embs.main(["--local_dir", str(tmp_path / "cohort"), "--device", "cpu"])
    got = load_pkl(out)
    names = list(jax_list_bags(str(bag_dir)))
    assert set(got) == {"embeds", "slide_ids"}
    assert got["slide_ids"] == [os.path.splitext(n)[0] for n in names]
    want = np.asarray([jax_load_features(str(bag_dir / n)).mean(axis=0) for n in names])
    assert got["embeds"].dtype == np.float32 and got["embeds"].shape == want.shape
    np.testing.assert_allclose(got["embeds"], want, rtol=0, atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            extract_mean_embs.main(["--local_dir", str(tmp_path / "cohort")])
