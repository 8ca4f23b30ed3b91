"""Few-shot linear probing of slide embeddings (JAX: madeleine_tpu/eval/
linear_probe.py; ref: bin/run_linear_probing.py:35-194).

The protocol is the JAX package's: k in {1, 10, 25} slides per class x 10
folds, fold f seeded by `set_deterministic_mode(f)`, an L2 logistic
regression (sklearn's `LogisticRegression(C=1)`), AUC (one-vs-rest macro
when the test labels hold more than two classes) and balanced accuracy, or
quadratic kappa and balanced accuracy for ``isup_grade``; one pickle
``{"tangle": store}`` per (k, task). Degenerate folds are skipped as there.

The card's machine has neither pandas nor sklearn, so this module keeps its
own counterparts of the calls the JAX package makes:

- the label CSV is read with the `csv` module (`read_labels`);
- pandas' ``rows.sample(k)`` draws ``np.random.choice(len(rows), k,
  replace=False)`` from numpy's global generator, so `split_ids` makes that
  draw per class, classes sorted, rows in CSV order: the folds' splits equal
  the JAX package's;
- `L2LogisticRegression` minimises sklearn's lbfgs objective (the log loss
  plus half the squared weights over C, the intercept unpenalised,
  multinomial above two classes) exactly, by damped Newton steps with a
  Cholesky solve in float64 on the probe's device;
- `roc_auc_score`, `balanced_accuracy_score`, `quadratic_kappa` and
  `standard_scale` follow sklearn's definitions, raising where it raises and
  returning NaN where it does.
"""

from __future__ import annotations

import csv
import os
import pickle
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from madeleine_torch.utils.device import resolve_device
from madeleine_torch.utils.file_utils import load_pkl
from madeleine_torch.utils.seed import set_deterministic_mode

BCNB_BREAST_TASKS = ["er", "pr", "her2"]
ALL_K = (1, 10, 25)
NUM_FOLDS = 10

Labels = List[Tuple[str, object]]
GRAD_TOL = 1e-12             # the fit stops at this largest gradient entry
MAX_NEWTON_STEPS = 100
FULL_STEP_DECREASE = 1e-13   # relative to f: below it the Newton step is taken whole


# ---------------------------------------------------------------------------
# Metrics (sklearn.metrics' definitions)
# ---------------------------------------------------------------------------

def _binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """Mann-Whitney AUC, tied scores given their average rank: equal to
    sklearn's trapezoid under the ROC curve. NaN with one class present."""
    n_pos = int(positive.sum())
    n_neg = len(positive) - n_pos
    if n_pos == 0 or n_neg == 0:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.")
        return float("nan")
    order = np.argsort(score, kind="stable")
    s = score[order]
    starts = np.r_[0, np.flatnonzero(s[1:] != s[:-1]) + 1]
    ends = np.r_[starts[1:], len(s)]
    ranks = np.empty(len(s))
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_score(y_true, y_score) -> float:
    """sklearn's `roc_auc_score`: binary with a 1-D score (the larger label
    positive), one-vs-rest macro with a 2-D one."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score, np.float64)
    classes = np.unique(y_true)
    if y_score.ndim == 1:
        return _binary_auc(y_true == classes[-1], y_score)
    if not np.allclose(1, y_score.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                         "i.e. they should sum up to 1.0 over classes")
    if len(classes) != y_score.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns "
                         "in 'y_score'")
    return float(np.mean([_binary_auc(y_true == c, y_score[:, i])
                          for i, c in enumerate(classes)]))


def balanced_accuracy_score(y_true, y_pred) -> float:
    """The mean recall over the classes of y_true; a predicted class that
    y_true lacks has no recall and is left out, as sklearn leaves it."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(y_true)
    if np.setdiff1d(np.unique(y_pred), labels).size:
        warnings.warn("y_pred contains classes not in y_true")
    recall = np.array([np.count_nonzero(y_pred[y_true == c] == c) / np.count_nonzero(y_true == c)
                       for c in labels])
    return float(np.mean(recall))


def quadratic_kappa(y1, y2) -> float:
    """sklearn's `cohen_kappa_score(y1, y2, weights="quadratic")`: weights
    (i - j)^2 over the indices of the sorted labels of both; NaN where
    undefined."""
    y1, y2 = np.asarray(y1), np.asarray(y2)
    labels = np.unique(np.concatenate([y1, y2]))
    n = len(labels)
    confusion = np.zeros((n, n))
    np.add.at(confusion, (np.searchsorted(labels, y1), np.searchsorted(labels, y2)), 1)
    sum0, sum1 = confusion.sum(axis=0), confusion.sum(axis=1)
    expected = np.outer(sum0, sum1) / np.sum(sum0)
    w = np.zeros((n, n)) + np.arange(n)
    w = (w - w.T) ** 2
    denominator = np.sum(w * expected)
    if denominator == 0:
        warnings.warn("cohen_kappa_score is undefined here (one label in common)")
        return float("nan")
    return float(1 - np.sum(w * confusion) / denominator)


def calculate_metrics(y_true, y_pred, pred_scores) -> Tuple[float, float]:
    """AUC + balanced accuracy (ref: run_linear_probing.py:35-51)."""
    if len(np.unique(y_true)) > 2:
        auc = roc_auc_score(y_true, pred_scores)
    else:
        auc = roc_auc_score(y_true, pred_scores[:, 1])
    return float(auc), balanced_accuracy_score(y_true, y_pred)


def standard_scale(x: np.ndarray) -> np.ndarray:
    """sklearn's `StandardScaler().fit_transform`: column mean and std
    (ddof 0) in float64, a near-constant column's scale set to 1, applied
    in x's dtype."""
    x = np.asarray(x)
    x64 = x.astype(np.float64)
    n = x64.shape[0]
    mean = x64.mean(axis=0)
    var = x64.var(axis=0)
    eps = np.finfo(np.float64).eps
    scale = np.sqrt(var)
    scale[var <= n * eps * var + (n * mean * eps) ** 2] = 1.0
    out = np.array(x, copy=True)
    out -= mean
    out /= scale
    return out


# ---------------------------------------------------------------------------
# The fit (sklearn's LogisticRegression(C=1) objective, solved exactly)
# ---------------------------------------------------------------------------

class L2LogisticRegression:
    """L2-penalised logistic regression in float64 on `device`.

    Minimises sklearn's lbfgs objective, (sum of log losses + |W|^2 / (2C)) / n,
    the intercept unpenalised: one weight vector on a sigmoid for two
    classes, one per class on a softmax above two. The softmax's intercepts
    are free along their common shift, which the optimum's probabilities do
    not see; a term (sum_k b_k)^2 / 2 pins them to sum zero, where lbfgs
    started from zero also leaves them. Damped Newton steps (Armijo
    backtracking, until the predicted decrease falls below f's float64
    resolution) solve it, each with a Cholesky factorisation of the
    Hessian, until the gradient's largest entry is at most GRAD_TOL.
    `predict` is sklearn's: the class of the largest decision value (the
    sigmoid's positive class where it exceeds 0), ties to the first class,
    i.e. the argmax of the probabilities."""

    def __init__(self, C: float = 1.0, device=None):
        self.C = C
        self.device = resolve_device(device)

    def _x(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        return torch.cat([x, x.new_ones(x.shape[0], 1)], dim=1)

    def _objective(self, theta, xt, y, need_hessian):
        """(f, gradient, Hessian or None) at theta [m, d+1]."""
        n, dims = xt.shape
        reg = torch.full((dims,), 1.0 / self.C, dtype=xt.dtype, device=xt.device)
        reg[-1] = 0.0
        z = xt @ theta.T                                     # [n, m]
        if theta.shape[0] == 1:                              # sigmoid
            z = z[:, 0]
            f = (torch.logaddexp(torch.zeros_like(z), z) - y * z).sum()
            p = torch.sigmoid(z)
            g = (xt.T @ (p - y))[None]
            h = None if not need_hessian else xt.T @ (xt * (p * (1 - p))[:, None])
        else:                                                # softmax
            f = (torch.logsumexp(z, dim=1) - z.gather(1, y[:, None])[:, 0]).sum()
            p = torch.softmax(z, dim=1)
            g = (p - torch.nn.functional.one_hot(y, theta.shape[0]).to(p.dtype)).T @ xt
            b = theta[:, -1].sum()
            f = f + 0.5 * b * b
            g[:, -1] += b
            h = None
            if need_hessian:
                k = theta.shape[0]
                xp = xt[:, None, :] * p[:, :, None]          # [n, k, d+1]
                h = -torch.einsum("ika,ilb->kalb", xp, xp)
                blocks = torch.einsum("ika,ib->kab", xp, xt)
                idx = torch.arange(k, device=xt.device)
                h[idx, :, idx, :] += blocks
                h[:, -1, :, -1] += 1.0                       # the intercepts' pin
                h = h.reshape(k * dims, k * dims)
        f = f + 0.5 * (reg * theta.square()).sum()
        g = g + reg * theta
        if need_hessian:
            h = h + torch.diag(reg.repeat(theta.shape[0]))
            h = h / n
        return f / n, g / n, h

    def fit(self, x, y) -> "L2LogisticRegression":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, "
                             f"but the data contains only one class: {self.classes_[0]!r}")
        xt = self._x(x)
        codes = torch.as_tensor(np.searchsorted(self.classes_, y), device=self.device)
        binary = len(self.classes_) == 2
        target = codes.to(xt.dtype) if binary else codes
        theta = xt.new_zeros(1 if binary else len(self.classes_), xt.shape[1])
        f, g, h = self._objective(theta, xt, target, True)
        self.n_iter_, g_max = 0, float(g.abs().max())
        while g_max > GRAD_TOL:
            if self.n_iter_ == MAX_NEWTON_STEPS:
                warnings.warn(f"L2LogisticRegression: no convergence in {MAX_NEWTON_STEPS} "
                              f"Newton steps (gradient {g_max:.3g})")
                break
            step = -torch.cholesky_solve(g.reshape(-1, 1), torch.linalg.cholesky(h))
            step = step.reshape(theta.shape)
            slope = float((g * step).sum())
            t = 1.0
            # Armijo backtracking while the predicted decrease is resolvable in
            # float64; below that the full Newton step, which converges
            # quadratically there and which a noisy comparison of f would stall
            if -slope > FULL_STEP_DECREASE * abs(float(f)):
                while float(self._objective(theta + t * step, xt, target, False)[0]) \
                        > float(f) + 1e-4 * t * slope:
                    t *= 0.5
                    if t < 1e-12:
                        raise FloatingPointError("L2LogisticRegression: the line search "
                                                 f"found no decrease (slope {slope:.3g})")
            theta = theta + t * step
            f, g, h = self._objective(theta, xt, target, True)
            g_max = float(g.abs().max())
            self.n_iter_ += 1
        theta = theta.cpu().numpy()
        self.coef_, self.intercept_ = theta[:, :-1], theta[:, -1]
        self._theta = torch.as_tensor(theta, device=self.device)
        return self

    def decision_function(self, x) -> torch.Tensor:
        z = self._x(x) @ self._theta.T
        return z[:, 0] if z.shape[1] == 1 else z

    def predict_proba(self, x) -> np.ndarray:
        z = self.decision_function(x)
        if z.ndim == 1:
            p = torch.sigmoid(z)
            return torch.stack([1 - p, p], dim=1).cpu().numpy()
        return torch.softmax(z, dim=1).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        z = self.decision_function(x)
        idx = (z > 0).long() if z.ndim == 1 else z.argmax(dim=1)
        return self.classes_[idx.cpu().numpy()]


# ---------------------------------------------------------------------------
# Labels and the split
# ---------------------------------------------------------------------------

def _label(value: str, path: str):
    if not value.strip():
        raise ValueError(f"{path}: an empty label cell; mark an unlabelled slide with -1")
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def read_labels(label_path: str, task: str) -> Labels:
    """[(slide_id, label)] of the rows whose `task` label is not -1, in the
    CSV's order (ref: run_linear_probing.py:134-137)."""
    with open(label_path, newline="") as f:
        rows = [(r["slide_id"], _label(r[task], label_path)) for r in csv.DictReader(f)]
    return [(sid, y) for sid, y in rows if y != -1]


def split_ids(labels: Labels, slide_ids: Sequence[str], k: int) -> Tuple[List[str], List[str]]:
    """(train ids, test ids): k slides per class drawn from numpy's global
    generator as pandas' ``sample(k)`` draws them (classes sorted, rows in
    CSV order after keeping the ids that have an embedding); the rest test."""
    present = set(slide_ids)
    rows = [(sid, y) for sid, y in labels if sid in present]
    train: List[str] = []
    for cls in sorted({y for _, y in rows}):
        ids = [sid for sid, y in rows if y == cls]
        k_eff = min(k, len(ids))
        if k_eff < k:
            print(f"* warning: class {cls} has only {len(ids)} slides; "
                  f"sampling k={k_eff} (reference would crash here)")
        train += [ids[i] for i in np.random.choice(len(ids), k_eff, replace=False)]
    chosen = set(train)
    return train, [sid for sid, _ in rows if sid not in chosen]


def _arrays(obj, labels: Labels, train: List[str], test: List[str], normalize: bool):
    embeddings = np.asarray(obj["embeds"])
    if normalize:
        embeddings = standard_scale(embeddings)
    emb_by_id = {str(n): e for e, n in zip(embeddings, obj["slide_ids"])}
    lab_by_id = dict(labels)
    return (np.stack([emb_by_id[n] for n in train]), np.asarray([lab_by_id[n] for n in train]),
            np.stack([emb_by_id[n] for n in test]), np.asarray([lab_by_id[n] for n in test]))


def load_and_split(labels: Labels, embedding_path: str, study: str, k: int = 1,
                   normalize: bool = False):
    """(x_train, y_train, x_test, y_test) of one fold (ref:
    run_linear_probing.py:54-111). `labels`: `read_labels(path, study)`."""
    obj = load_pkl(embedding_path)
    train, test = split_ids(labels, [str(x) for x in obj["slide_ids"]], k)
    return _arrays(obj, labels, train, test, normalize)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def eval_single_task(
    embeds_path: str,
    label_path: str,
    tasks: Sequence[str],
    *,
    ks: Sequence[int] = ALL_K,
    num_folds: int = NUM_FOLDS,
    verbose: bool = True,
    save: bool = True,
    device=None,
    record: Optional[list] = None,
) -> Dict[Tuple[int, str], Dict[str, List[float]]]:
    """Full probing sweep (ref: run_linear_probing.py:114-194). Returns
    {(k, task): {"auc": [...], "bacc": [...], "q_kappa": [...]}} and writes
    the per-(k, task) pickles under ``<dir of embeds_path>/res_linear_probing/
    <m_name>/``. The fits run on `device` (default CUDA). With `record`, a
    list, each fit appends {"k", "task", "fold", "train_ids", "test_ids",
    "proba", "newton_steps", "seconds"} (the fit's and predictions' wall
    time, which ends in a copy to the host)."""
    dev = resolve_device(device)
    m_name = os.path.splitext(os.path.basename(embeds_path))[0]
    save_path = os.path.join(os.path.dirname(embeds_path), "res_linear_probing")
    obj = load_pkl(embeds_path)
    slide_ids = [str(x) for x in obj["slide_ids"]]

    all_metrics: Dict[Tuple[int, str], Dict[str, List[float]]] = {}
    for k in ks:
        for task in tasks:
            metrics_store: Dict[str, List[float]] = {"auc": [], "bacc": [], "q_kappa": []}
            labels = read_labels(label_path, task)
            for fold in range(num_folds):
                set_deterministic_mode(fold)
                train, test = split_ids(labels, slide_ids, k)
                x_tr, y_tr, x_te, y_te = _arrays(obj, labels, train, test, False)
                if len(y_te) == 0 or len(np.unique(y_tr)) < 2:
                    print(f"* warning: k={k} task={task} fold={fold}: "
                          f"degenerate split (|test|={len(y_te)}); skipped")
                    continue
                t0 = time.perf_counter()
                clf = L2LogisticRegression(C=1.0, device=dev).fit(x_tr, y_tr)
                y_pred = clf.predict(x_te)
                scores = clf.predict_proba(x_te)
                if record is not None:
                    record.append({"k": k, "task": task, "fold": fold, "train_ids": train,
                                   "test_ids": test, "proba": scores, "newton_steps": clf.n_iter_,
                                   "seconds": time.perf_counter() - t0})

                if task == "isup_grade":
                    metrics_store["q_kappa"].append(quadratic_kappa(y_te, y_pred))
                    metrics_store["bacc"].append(balanced_accuracy_score(y_te, y_pred))
                else:
                    auc, bacc = calculate_metrics(y_te, y_pred, scores)
                    metrics_store["auc"].append(auc)
                    metrics_store["bacc"].append(bacc)

            all_metrics[(k, task)] = metrics_store
            if verbose:
                if task == "isup_grade":
                    print(f"k={k}, task={task}, quadratic kappa="
                          f"{np.mean(metrics_store['q_kappa']):.3f}")
                else:
                    print(f"k={k}, task={task}, "
                          f"auc={np.mean(metrics_store['auc']):.3f} "
                          f"+/- {np.std(metrics_store['auc']):.3f}")
            if save:
                folder = f"k={k}_probing_{task.replace('/', '')}"
                os.makedirs(os.path.join(save_path, m_name), exist_ok=True)
                with open(os.path.join(save_path, m_name, f"{folder}.pickle"), "wb") as f:
                    pickle.dump({"tangle": metrics_store}, f, protocol=pickle.HIGHEST_PROTOCOL)
    return all_metrics
