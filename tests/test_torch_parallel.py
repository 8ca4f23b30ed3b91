"""Data parallelism in the port (`madeleine_torch/parallel/`, the train
step's group lane) on the CPU: two ranks on Gloo against the port at world
size 1 and against the JAX package's 2-device mesh.

Two worker processes (`tests/torch_parallel_worker.py`, torchrun's
environment, started once for the module) compute every case; each test
reads its case from their saved results, while this process computes the
references. The shapes are tests/test_fused_sharded.py's (BS 16, 3 stains,
t 32, d 16, f32); the bag-parallel ones tests/test_parallel.py's.

- Steps at the real dropout rates (dense and ragged, n_views 1 and 3)
  against the port at world size 1: slide embeddings rtol 1e-5 / atol
  1e-6, the loss rtol 2e-5, each gradient 1e-4 relative Frobenius (each
  attention_c bias, whose exact gradient is 0, within 1e-4); a control
  with the single-process dropout offsets m * lb on every rank misses the
  embedding bar.
- Steps at rate 0 against JAX's `make_train_step(cfg, tx, mesh=make_mesh(2))`
  (its fused op in interpret mode), JAX's GOT draw and half split handed
  over: test_fused_sharded.py's bars.
- No collective of a step sends a tensor as large as one rank's feats.
- `encode_bag_parallel`, `run_inference`'s group lane and `train_loop`'s
  epoch-end gather against their single-process results.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.config import MadeleineConfig as JaxConfig
from madeleine_tpu.models.madeleine import init_madeleine_params
from madeleine_tpu.ops import losses as JL
from madeleine_tpu.parallel import mesh as jax_mesh
from madeleine_tpu.parallel.bag_parallel import encode_bag_parallel as jax_bag_parallel
from madeleine_tpu.train import optim as jax_optim
from madeleine_tpu.train import trainer as jax_trainer
from madeleine_torch.config import MadeleineConfig
from madeleine_torch.eval.inference import run_inference
from madeleine_torch.models.factory import params_from_jax
from madeleine_torch.models.madeleine import MADELEINE, encode
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import losses as L
from madeleine_torch.parallel.mesh import assert_no_large_collective
from madeleine_torch.train import trainer
from madeleine_torch.train.optim import make_optimizer
from tests import test_torch_ragged as TR
from tests import test_torch_views as TV

WORLD = 2
BS, N_MOD, T, D = 16, 3, 32, 16
LAYOUTS = ["dense-nviews1", "dense-nviews3", "ragged-nviews1", "ragged-nviews3"]
RATES_SEED = 5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
STEP_PURPOSES = {"embeddings", "labels", "got_stats", "got_stats_grad", "got_sums", "grads"}


def _fields(intra: bool):
    """tests/test_fused_sharded.py::_cfg's fields."""
    return dict(patch_embedding_dim=D, wsi_encoder_hidden_dim=16, attention_hidden_dim=16,
                n_heads=2, precision="float32", dataset="__test__", MODALITIES=["HE", "X", "Y"],
                temperature=0.01, lr=1e-3, max_epochs=2, warmup=True, warmup_epochs=1,
                batch_size=BS, got_subsample=8, global_loss="info-nce", local_loss="got",
                symmetric_cl=True, intra_modality_loss="info-nce" if intra else "-1")


def _bag_fields(add_se: bool):
    """tests/test_parallel.py::_cfg's fields."""
    return dict(patch_embedding_dim=16, wsi_encoder_hidden_dim=32, attention_hidden_dim=32,
                n_heads=2, precision="float32", add_stain_encoding=add_se, dataset="__test__",
                MODALITIES=["HE", "X", "Y"])


def _batch(ragged: bool, seed: int = 3):
    """tests/test_fused_sharded.py::_batch, in numpy."""
    rng = np.random.default_rng(seed)
    labels = np.ones((BS, N_MOD), np.float32)
    labels[:, 2] = (rng.random(BS) < 0.7).astype(np.float32)
    batch = {"feats": rng.standard_normal((BS, N_MOD, T, D)).astype(np.float32),
             "modality_labels": labels, "sample_mask": np.ones(BS, bool)}
    if ragged:
        lengths = rng.integers(T // 2, T + 1, size=(BS, N_MOD))
        batch["token_mask"] = np.arange(T)[None, None, :] < lengths[:, :, None]
    return batch


def _layout(name):
    ragged, nv = name.split("-")
    return ragged == "ragged", nv == "nviews3"


def _jax_draws(ragged: bool, intra: bool, sub: int = 8):
    """The GOT draw and half split of JAX's step at PRNGKey(0), for the port's batch."""
    key = jax.random.PRNGKey(0)
    out = {}
    if ragged:
        out["got_gumbel"] = torch.from_numpy(TR._jax_got_noise(key, N_MOD, BS, T))
    else:
        _, loss_rng = jax.random.split(key)
        got_rngs = jax.random.split(loss_rng, N_MOD)
        out["got_indices"] = [
            torch.from_numpy(np.array(jax.random.permutation(
                jax.random.split(got_rngs[s])[0], T)[:sub])) for s in range(1, N_MOD)]
    if intra:
        out["half_mask"] = torch.from_numpy(TV._jax_half(0, T))
    return out


def _state_dict(fields, seed=0):
    jcfg = JaxConfig(**fields).finalize()
    params = jax.tree_util.tree_map(np.asarray, init_madeleine_params(jax.random.PRNGKey(seed),
                                                                      jcfg))
    return jcfg, params, params_from_jax(params)


def _port_model(fields, sd) -> MADELEINE:
    model = MADELEINE(MadeleineConfig(**fields).finalize())
    model.load_state_dict(sd, strict=True)
    return model


def _cases():
    cases, refs = [], {}
    for name in LAYOUTS:
        ragged, intra = _layout(name)
        fields = _fields(intra)
        jcfg, params, sd = _state_dict(fields)
        batch = _batch(ragged)
        cases.append(dict(kind="step", name=f"{name}-rates", cfg=fields, state_dict=sd,
                          batch=batch, seed=RATES_SEED))
        cases.append(dict(kind="step", name=f"{name}-jax", cfg=fields, state_dict=sd,
                          batch=dict(batch, **_jax_draws(ragged, intra)), seed=0,
                          rates_zero=True))
        refs[name] = (jcfg, params)
    fields = _fields(False)
    _, _, sd = _state_dict(fields)
    cases.append(dict(kind="step", name="dense-nviews1-wrong_offsets", cfg=fields,
                      state_dict=sd, batch=_batch(False), seed=RATES_SEED, wrong_offsets=True))
    bf = dict(fields, precision="bfloat16")
    cases.append(dict(kind="step", name="dense-nviews1-bf16", cfg=bf, state_dict=sd,
                      batch=_batch(False), seed=RATES_SEED))
    cases.append(dict(kind="loop", name="loop", cfg=fields, state_dict=sd, seed=7,
                      batches=[_batch(False, 11), _batch(False, 12)]))
    rng = np.random.default_rng(0)
    cases.append(dict(kind="info_nce", name="info_nce",   # test_parallel.py:61's shapes
                      q=torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
                      k=torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
                      mask=torch.from_numpy(rng.random(16) < 0.8)))
    for se in (False, True):
        bf = _bag_fields(se)
        _, params, bsd = _state_dict(bf)
        b, t = 2, 8 * 37   # test_parallel.py:31's shapes
        feats = rng.standard_normal((b, t, 16)).astype(np.float32)
        mask = rng.random((b, t)) < 0.9
        cases.append(dict(kind="bag", name=f"bag-se{int(se)}", cfg=bf, state_dict=bsd,
                          feats=torch.from_numpy(feats), mask=torch.from_numpy(mask),
                          stain_idx=1 if se else 0))
        refs[f"bag-se{int(se)}"] = params
    bf = _bag_fields(False)
    _, _, bsd = _state_dict(bf, seed=1)
    batches = []
    for i, (b, t) in enumerate([(4, 40), (3, 24), (2, 64)]):   # 4 and 2 split, 3 runs whole
        lengths = rng.integers(t // 3, t + 1, size=b)
        batches.append({"feats": rng.standard_normal((b, t, 16)).astype(np.float32),
                        "mask": np.arange(t)[None, :] < lengths[:, None],
                        "slide_ids": [f"s{i}_{j}" for j in range(b)], "n_valid": b})
    cases.append(dict(kind="inference", name="inference", cfg=bf, state_dict=bsd,
                      batches=batches))
    return cases, refs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(cases_path, out_dir):
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, cases_path, out_dir], env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _port_step(case):
    """The port's step at world size 1 on the whole batch (no group)."""
    model = _port_model(case["cfg"], case["state_dict"])
    opt, sched = make_optimizer(model.cfg, model.parameters(), steps_per_epoch=4)
    step = trainer.make_train_step(model.cfg, model, opt, sched)
    rates = (et.PRE_RATE, et.GATE_RATE)
    if case.get("rates_zero"):
        et.PRE_RATE = et.GATE_RATE = 0.0
    try:
        he, metrics = step(case["batch"], case["seed"])
    finally:
        et.PRE_RATE, et.GATE_RATE = rates
    return {"he": he, "loss": metrics["loss"], "skipped": bool(metrics["skipped"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None}}


def _jax_mesh_step(jcfg, params, batch):
    """JAX's 2-device mesh step (fused op in interpret mode, rates 0) at PRNGKey(0)."""
    tx, _ = jax_optim.make_optimizer(jcfg, steps_per_epoch=4)
    mesh = jax_mesh.make_mesh(WORLD)
    state = jax_trainer.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_trainer.make_train_step(jcfg, tx, mesh=mesh, donate=False)
    jb = jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    state, he, metrics = step(state, jb, jax.random.PRNGKey(0))
    return {"loss": float(metrics["loss"]), "skipped": bool(metrics["skipped"]),
            "he": np.asarray(he),
            "params": params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: [rank 0's result, rank 1's]}, {reference name: value}): the
    workers run while this process computes the references."""
    out_dir = str(tmp_path_factory.mktemp("dp"))
    cases, jax_refs = _cases()
    cases_path = os.path.join(out_dir, "cases.pt")
    torch.save(cases, cases_path)
    procs = _start_workers(cases_path, out_dir)
    try:
        refs = {}
        by_name = {c["name"]: c for c in cases}
        for name in LAYOUTS:
            refs[f"{name}-rates"] = _port_step(by_name[f"{name}-rates"])
        refs["dense-nviews1-wrong_offsets"] = refs["dense-nviews1-rates"]
        refs["dense-nviews1-bf16"] = _port_step(by_name["dense-nviews1-bf16"])
        loop = by_name["loop"]
        model = _port_model(loop["cfg"], loop["state_dict"])
        opt, sched = make_optimizer(model.cfg, model.parameters(), steps_per_epoch=4)
        loss, rank, agg = trainer.train_loop(model.cfg, trainer.make_train_step(
            model.cfg, model, opt, sched), loop["batches"], 0, loop["seed"])
        refs["loop"] = {"loss": loss, "rank": rank, "n_steps": agg["n_steps"]}
        case = by_name["info_nce"]
        q, k = (case[n].clone().requires_grad_(True) for n in ("q", "k"))
        loss = L.info_nce(q, k, temperature=0.01, symmetric=True, mask=case["mask"])
        loss.backward()
        refs["info_nce"] = {"loss": loss.item(), "dq": q.grad, "dk": k.grad, "jax": float(
            JL.info_nce(jnp.asarray(case["q"].numpy()), jnp.asarray(case["k"].numpy()),
                        temperature=0.01, symmetric=True, mask=jnp.asarray(case["mask"].numpy())))}
        inf = by_name["inference"]
        res, rank = run_inference(_port_model(inf["cfg"], inf["state_dict"]), inf["batches"],
                                  device="cpu", verbose=False)
        refs["inference"] = {"embeds": res["embeds"], "slide_ids": res["slide_ids"],
                             "rank": rank}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MADELEINE_FORCE_FUSED", "1")
            mp.setenv("MADELEINE_NO_GOT_GLUE", "1")
            for name in LAYOUTS:
                jcfg, params = jax_refs[name]
                refs[f"{name}-jax"] = _jax_mesh_step(jcfg, params, _batch(_layout(name)[0]))
        for se in (0, 1):
            case = by_name[f"bag-se{se}"]
            bf = _bag_fields(bool(se))
            jcfg = JaxConfig(**bf).finalize()
            feats, mask = case["feats"].numpy(), case["mask"].numpy()
            params = jax.tree_util.tree_map(jnp.asarray, jax_refs[f"bag-se{se}"])
            with torch.no_grad():
                port = encode(_port_model(bf, case["state_dict"]), case["feats"],
                              stain_idx=case["stain_idx"], mask=case["mask"])
            refs[f"bag-se{se}"] = {
                "port": port.numpy(),
                "jax": np.asarray(jax_bag_parallel(
                    params, jcfg, jnp.asarray(feats),
                    jax_mesh.make_mesh(WORLD, axis_names=(jax_mesh.BAG_AXIS,)),
                    mask=jnp.asarray(mask), stain_idx=case["stain_idx"]))}
        for proc, log in procs:
            rc = proc.wait(timeout=600)
            log.close()
            if rc != 0:
                logs = "\n".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:]
                                 for r in range(WORLD))
                raise AssertionError(f"a worker failed (rc {rc}):\n{logs}")
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
               for r in range(WORLD)]
    return {k: [r[k] for r in results] for k in results[0]}, refs


def _he(ranks):
    return torch.cat([r["he"] for r in ranks]).numpy()


def _rel_fro(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_steps_at_the_real_rates_match_world_size_1(runs, layout):
    """World 2 against the port at world 1, real dropout rates: the ranks'
    H&E embeddings in rank order rtol 1e-5 / atol 1e-6, the loss rtol 2e-5
    and the same on both ranks, each gradient (summed over the ranks, the
    same on both) 1e-4 relative Frobenius, each attention_c bias (an exact
    0, rounding noise on both sides) within 1e-4."""
    res, refs = runs
    ranks, ref = res[f"{layout}-rates"], refs[f"{layout}-rates"]
    assert not ref["skipped"] and not any(r["skipped"] for r in ranks)
    np.testing.assert_allclose(_he(ranks), ref["he"].numpy(), rtol=1e-5, atol=1e-6)
    assert float(ranks[0]["loss"]) == float(ranks[1]["loss"])
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(ref["loss"]), rtol=2e-5)
    assert ranks[0]["grads"].keys() == ranks[1]["grads"].keys() == ref["grads"].keys()
    for k, want in ref["grads"].items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        got = ranks[0]["grads"][k]
        if k.endswith("attention_c.bias"):
            assert float((got - want).abs().max()) <= 1e-4, k
        else:
            assert _rel_fro(got, want) < 1e-4, (k, _rel_fro(got, want))


def test_the_single_process_offsets_miss_the_embedding_bar(runs):
    """The control: every rank keying its masks by the single-process
    offsets m * lb (rule 1's wrong answer) draws other masks, and its
    embeddings miss the bar the right offsets meet."""
    res, refs = runs
    want = refs["dense-nviews1-rates"]["he"].numpy()
    wrong = _he(res["dense-nviews1-wrong_offsets"])
    right = _he(res["dense-nviews1-rates"])
    np.testing.assert_allclose(right, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(wrong, want, rtol=1e-5, atol=1e-6)


def test_bf16_gradients_differ_by_the_ranks_rounding_alone(runs):
    """The bf16 step (the card's precision) at world 2 against world 1: the
    embeddings and the loss equal, but each rank rounds its gradients of
    the bf16 operands to bf16 before their sum over ranks (as the JAX
    package does), so the gradients agree only to that rounding: within one
    bf16 step, 2^-8, of ||g1|| + sum_r ||g_r||, where the f32 step above
    meets 1e-4 relative Frobenius. This is the bar chip_smoke.py's
    data_parallel phase holds world 2 to on the card."""
    res, refs = runs
    ranks, ref = res["dense-nviews1-bf16"], refs["dense-nviews1-bf16"]
    np.testing.assert_allclose(_he(ranks).astype(np.float32),
                               ref["he"].float().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(ref["loss"]), rtol=2e-5)
    worst = 0.0
    for k, want in ref["grads"].items():
        if k.endswith("attention_c.bias"):
            continue
        diff = (ranks[0]["grads"][k] - want).norm()
        summands = want.norm() + sum(r["local_grads"][k].norm() for r in ranks)
        worst = max(worst, float(diff / summands))
    assert worst <= 2.0 ** -8, worst
    assert worst > 1e-5   # the rounding shows: this is not the f32 step


@pytest.mark.parametrize("layout", LAYOUTS)
def test_steps_at_rate_0_match_the_jax_mesh_step(runs, layout):
    """World 2 at rate 0 against JAX's make_train_step on a 2-device mesh,
    JAX's GOT draw and half split handed over: the loss rtol 2e-5, the H&E
    embeddings rtol 1e-5 / atol 1e-6, the weights after the step rtol 1e-4
    / atol 1e-6 (tests/test_fused_sharded.py's bars), on both ranks."""
    res, refs = runs
    ranks, ref = res[f"{layout}-jax"], refs[f"{layout}-jax"]
    assert not ref["skipped"] and not any(r["skipped"] for r in ranks)
    np.testing.assert_allclose(float(ranks[0]["loss"]), ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(_he(ranks), ref["he"], rtol=1e-5, atol=1e-6)
    for r in ranks:
        for k, want in ref["params"].items():
            np.testing.assert_allclose(r["params"][k].numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_collective_moves_a_bag_sized_tensor(runs, layout):
    """A step's collectives send embeddings, labels, the GOT statistics and
    their gradient, the per-stain sums and one gradient buffer, each far
    below one rank's feats shard; the gradient buffer is the parameters,
    sent once."""
    res, _ = runs
    traffic = res[f"{layout}-rates"][0]["traffic"]
    assert set(traffic) == STEP_PURPOSES
    assert_no_large_collective(traffic, (BS // WORLD) * N_MOD * T * D)
    n_params = sum(g.numel() for g in res[f"{layout}-rates"][0]["grads"].values())
    assert traffic["grads"] == {"calls": 1, "bytes": 4 * n_params, "max_numel": n_params}
    with pytest.raises(AssertionError, match="bag-sized"):
        assert_no_large_collective(traffic, n_params, exempt=())


def test_info_nce_global_matches_the_whole_batch(runs):
    """`info_nce_global` over two ranks' rows (16 x 8, a mask, symmetric,
    temperature 0.01): the loss on both ranks equals `info_nce` on the whole
    batch and JAX's `info_nce` at rtol 1e-5, and each rank's gradient is its
    rows of the whole batch's at rtol 1e-5 / atol 1e-7 (the gather's
    backward returns this rank's slice)."""
    res, refs = runs
    ref = refs["info_nce"]
    for r, got in enumerate(res["info_nce"]):
        np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(got["loss"]), ref["jax"], rtol=1e-5)
        rows = slice(8 * r, 8 * r + 8)
        for g, w in ((got["dq"], ref["dq"][rows]), (got["dk"], ref["dk"][rows])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("se", [0, 1], ids=["plain", "stain_encoding"])
def test_bag_parallel_matches_encode_and_jax(runs, se):
    """Each bag's tokens split over the two ranks (b 2, t 296): the same
    embeddings on both ranks, equal to the port's `encode` of the whole bag
    and to JAX's encode_bag_parallel on a 2-device bag mesh at rtol 1e-5 /
    atol 1e-6, with and without stain encodings."""
    res, refs = runs
    ranks, ref = res[f"bag-se{se}"], refs[f"bag-se{se}"]
    assert torch.equal(ranks[0], ranks[1])
    np.testing.assert_allclose(ranks[0].numpy(), ref["port"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0].numpy(), ref["jax"], rtol=1e-5, atol=1e-6)


def test_inference_lane_matches_world_size_1(runs):
    """Batches of 4 and 2 split by rank and gathered, one of 3 run whole on
    each rank: every rank's embeddings equal world 1's per row at rtol 1e-5
    / atol 1e-6, in the same order."""
    res, refs = runs
    ref = refs["inference"]
    for r in res["inference"]:
        assert r["slide_ids"] == ref["slide_ids"]
        np.testing.assert_allclose(r["embeds"], ref["embeds"], rtol=1e-5, atol=1e-6)


def test_train_loop_gathers_the_epochs_embeddings(runs):
    """Two steps of `train_loop`: the epoch loss rtol 2e-5 and the smooth
    rank of the gathered H&E embeddings rtol 1e-5 against world 1, the
    same on both ranks; rows gathered in rank order."""
    res, refs = runs
    a, b = res["loop"]
    ref = refs["loop"]
    assert a == b and a["n_steps"] == ref["n_steps"] == 2
    np.testing.assert_allclose(a["loss"], ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(a["rank"], ref["rank"], rtol=1e-5)
    rows, mask = res["allgather_rows"][0]
    assert rows.tolist() == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
    assert mask.tolist() == [True, True, True, False]
