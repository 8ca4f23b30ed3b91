"""The port's setup family (madeleine_torch/setup.py) against what the
pretrain CLI builds from the same flags; its profiling utilities
(madeleine_torch/utils/profiling.py) on the CPU; and the route from a JAX
(orbax) checkpoint to the port: the JAX package writes model.pt from the
restored params, and the port loads it strictly and computes JAX's eval
forward at f32 rtol 1e-4 / atol 1e-5."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from madeleine_torch import setup as S
from madeleine_torch.cli import pretrain
from madeleine_torch.data.datasets import BucketedBagLoader, RaggedTrainLoader, TrainLoader
from madeleine_torch.models.factory import create_model
from madeleine_torch.models.madeleine import MADELEINE, forward_train
from madeleine_torch.ops import losses as L
from madeleine_torch.train.optim import GatedAdamW, make_optimizer
from madeleine_torch.utils import profiling as P
from madeleine_torch.utils.args import build_parser, config_from_args
from tests.test_torch_pretrain import _argv, _write_cohort
from tests.torch_port_helpers import configs, to_torch

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    _, _, down = _write_cohort(root, 7, 16, lengths=(20, 60))
    return root, down


def _cli_config(argv):
    """The pretrain CLI's own parse (build_parser + --device, config_from_args)."""
    parser = build_parser()
    parser.add_argument("--device", type=str, default="cuda")
    return config_from_args(parser.parse_args(argv), 1)


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("n_subsamples", ["32", "-1"])
def test_setup_family_builds_what_the_cli_builds(cohort, n_subsamples):
    root, down = cohort
    argv = [a for a in _argv(root, os.path.join(root, f"res{n_subsamples}"), 1)
            if a not in ("--device", "cpu")]
    argv[argv.index("--n_subsamples") + 1] = n_subsamples
    cfg = S.setup(argv)
    want = _cli_config(argv + ["--device", "cpu"])
    assert cfg.to_dict() == want.to_dict() and cfg.RESULTS_SAVE_PATH == want.RESULTS_SAVE_PATH
    with open(os.path.join(cfg.RESULTS_SAVE_PATH, "config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(cfg.to_dict()))

    loader = S.setup_dataloader(cfg, S.setup_dataset(cfg))
    cli_loader, name = pretrain.make_loader(want, "off", torch.device("cpu"))
    assert name == "python" and type(loader) is type(cli_loader)
    assert isinstance(loader, RaggedTrainLoader if n_subsamples == "-1" else TrainLoader)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        cli_loader.set_epoch(epoch)
        _batches_equal(list(loader), list(cli_loader))

    model = S.setup_model(cfg, device="cpu")
    _, cli_model = create_model(want, seed=want.seed, device="cpu")
    assert isinstance(model, MADELEINE)
    for (k, v), (k2, v2) in zip(model.state_dict().items(), cli_model.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    opt, sched = S.setup_optim(cfg, model, len(loader))
    cli_opt, cli_sched = make_optimizer(want, cli_model.parameters(), len(cli_loader))
    assert isinstance(opt, GatedAdamW)
    assert [sched(i) for i in range(0, 20, 3)] == [cli_sched(i) for i in range(0, 20, 3)]
    assert opt.defaults == cli_opt.defaults

    g, loc, intra = S.setup_losses(cfg)
    assert g is not None and loc is L.got_loss_multi and intra is None
    assert g.func is L.info_nce
    assert g.keywords == {"temperature": cfg.temperature, "symmetric": cfg.symmetric_cl}
    assert S.setup_mesh(cfg) is None          # one process: no mesh
    ds = S.setup_downstream_datasets(cfg, {"BCNB": down})
    assert isinstance(ds["BCNB"], BucketedBagLoader)
    assert ds["BCNB"].features_path == os.path.join(down, "patch_embeddings")


def test_setup_losses_with_the_intra_loss(cohort):
    root, _ = cohort
    argv = [a for a in _argv(root, os.path.join(root, "res_intra"), 1)
            if a not in ("--device", "cpu")] + ["--intra_modality_loss", "info-nce"]
    _, _, intra = S.setup_losses(S.setup(argv))
    q = torch.randn(4, 8)
    assert torch.isfinite(intra(q, q + 0.1))


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_the_ranges(tmp_path):
    with P.trace(None) as prof:
        assert prof is None
    log_dir = str(tmp_path / "prof")
    with P.trace(log_dir):
        with P.annotate("port_range_a"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with P.annotate("port_range_b"):
            torch.randn(16).sum()
    path = os.path.join(log_dir, P.TRACE_FILE)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"port_range_a", "port_range_b"} <= names
    assert P.module_device_ms(log_dir, "port_range_a") is None    # no GPU range on the CPU


def test_step_timer_statistics(monkeypatch):
    import types

    clock = iter([10.0, 11.0, 11.0, 13.0, 13.0, 13.5, 14.0, 18.0])
    monkeypatch.setattr(P, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    timer = P.StepTimer(skip_first=1)
    assert timer.stats() == {"steps": 0}
    durations = []
    for _ in range(4):
        timer.start()
        durations.append(timer.stop(sync=torch.zeros(1)))
    assert durations == [1.0, 2.0, 0.5, 4.0]
    st = timer.stats()
    assert st["steps"] == 3 and st["total_s"] == 6.5 and st["mean_s"] == pytest.approx(6.5 / 3)
    assert st["p50_s"] == 2.0 and st["p95_s"] == pytest.approx(np.percentile([2, 0.5, 4], 95))


def test_module_device_ms_reads_gpu_ranges(tmp_path):
    events = [{"ph": "X", "cat": "gpu_user_annotation", "name": "train_step_3", "dur": d}
              for d in (1000.0, 3000.0, 2000.0)]
    events += [{"ph": "X", "cat": "user_annotation", "name": "train_step_3", "dur": 9e6},
               {"ph": "X", "cat": "kernel", "name": "gemm", "dur": 5.0},
               {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": "x"}}]
    assert P.module_device_ms(str(tmp_path), "train_step") is None      # no trace yet
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    assert P.module_device_ms(str(tmp_path), "train_step") == 2.0
    assert P.module_device_ms(str(tmp_path), "eval_forward") is None


# ---------------------------------------------------------------------------
# a JAX (orbax) checkpoint in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stain_encoding", [False, True])
def test_orbax_checkpoint_reaches_the_port_through_model_pt(tmp_path, stain_encoding):
    from madeleine_tpu.models.factory import export_torch_checkpoint
    from madeleine_tpu.models.madeleine import forward_train as jax_forward
    from madeleine_tpu.models.madeleine import init_madeleine_params
    from madeleine_tpu.train.checkpoint import restore_params, save_params

    jcfg, pcfg = configs(add_stain_encoding=stain_encoding)
    params = jax.jit(lambda key: init_madeleine_params(key, jcfg))(jax.random.PRNGKey(9))
    save_params(str(tmp_path / "orbax"), params)
    with pytest.raises(NotImplementedError, match="export_torch_checkpoint"):
        create_model(pcfg, checkpoint_path=str(tmp_path / "orbax"), device="cpu")
    export_torch_checkpoint(restore_params(str(tmp_path / "orbax")), str(tmp_path / "model.pt"))
    _, model = create_model(pcfg, checkpoint_path=str(tmp_path / "model.pt"), device="cpu")

    feats = np.random.default_rng(10).standard_normal(
        (2, pcfg.n_modalities, 30, pcfg.patch_embedding_dim)).astype(np.float32)
    want_s, want_t = jax.jit(lambda p, f: jax_forward(p, jcfg, f, train=False))(params, feats)
    got_s, got_t = forward_train(model, to_torch(feats), train=False)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
