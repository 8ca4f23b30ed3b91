"""The slice as a whole: checkpoint bridge, encode paths against the JAX
package, and against the golden fixtures made from the reference torch model.
Bar: rtol 1e-4 / atol 1e-5 (tests/test_golden.py), f32 on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import madeleine as mtm
from madeleine_tpu.models.factory import params_to_state_dict
from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models import madeleine as port
from madeleine_torch.models.factory import (create_model, create_model_from_pretrained,
                                            export_torch_checkpoint, params_from_jax)
from madeleine_torch.models.madeleine import MADELEINE
from tests.torch_port_helpers import (GOLDEN_DIR, configs, flagship_state_dict, jax_params,
                                      kernel_route_encode, port_model, ragged_mask, to_torch)

TOL = dict(rtol=1e-4, atol=1e-5)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_params_from_jax_inverts_the_jax_bridge():
    jcfg, _ = configs(add_stain_encoding=True)
    params = jax_params(jcfg, seed=0)
    want = params_to_state_dict(params)
    got = params_from_jax(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("stain_idx", [0, 2])
def test_encode_matches_jax(stain_idx):
    jcfg, cfg = configs(add_stain_encoding=True)
    params = jax_params(jcfg, seed=1)
    model = port_model(cfg, params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 90, 64)).astype(np.float32)
    mask = ragged_mask([90, 41, 5], 90)
    want = mtm.encode(_jnp(params), jcfg, jnp.asarray(x), stain_idx=stain_idx,
                      mask=jnp.asarray(mask))
    got = port.encode(model, to_torch(x), stain_idx=stain_idx, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg="plain route")
    got = kernel_route_encode(model, to_torch(x), stain_idx=stain_idx,
                              mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg="kernel route")


def test_encode_he_and_attention_match_jax():
    jcfg, cfg = configs()
    params = jax_params(jcfg, seed=2)
    model = port_model(cfg, params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 70, 64)).astype(np.float32)
    mask = ragged_mask([70, 33], 70)
    want = mtm.encode_he(_jnp(params), jcfg, jnp.asarray(x), mask=jnp.asarray(mask))
    got = port.encode_he(model, to_torch(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_e, want_a = mtm.encode_with_attention(_jnp(params), jcfg, jnp.asarray(x),
                                               mask=jnp.asarray(mask))
    got_e, got_a = port.encode_with_attention(model, to_torch(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def _golden_model(gold):
    sd = {k[len("sd/"):]: torch.from_numpy(gold[k]) for k in gold.files if k.startswith("sd/")}
    cfg = MadeleineConfig(patch_embedding_dim=24, wsi_encoder_hidden_dim=512,
                          attention_hidden_dim=512, n_heads=2, precision="float32",
                          dataset="__golden__", MODALITIES=["HE", "HER2", "PGR"]).finalize()
    model = MADELEINE(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_golden_encode_he_and_attention():
    gold = np.load(os.path.join(GOLDEN_DIR, "golden.npz"))
    model = _golden_model(gold)
    got = port.encode_he(model, to_torch(gold["encode_he/in"]))
    np.testing.assert_allclose(got.numpy(), gold["encode_he/out"], **TOL)
    got = kernel_route_encode(model, to_torch(gold["encode_he/in"]))
    np.testing.assert_allclose(got.numpy(), gold["encode_he/out"], **TOL)
    emb, raw = port.encode_with_attention(model, to_torch(gold["attn/in"]))
    np.testing.assert_allclose(emb.numpy(), gold["attn/emb"].squeeze(1), **TOL)
    np.testing.assert_allclose(raw.numpy(), gold["attn/raw"].squeeze(2), **TOL)


def test_golden_flagship_encode_he_and_attention():
    """Full published width: 512-d in, hidden 512, 4 heads, attention 512."""
    gold = np.load(os.path.join(GOLDEN_DIR, "golden_flagship.npz"))
    cfg = MadeleineConfig(precision="float32", dataset="ACROBAT").finalize()
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()},
                          strict=True)
    model.eval()
    for route in (port.encode_he, kernel_route_encode):
        got = route(model, to_torch(gold["fs/encode_he/in"]))
        np.testing.assert_allclose(got.numpy(), gold["fs/encode_he/out"], **TOL,
                                   err_msg=route.__name__)
    emb, raw = port.encode_with_attention(model, to_torch(gold["fs/attn/in"]))
    np.testing.assert_allclose(emb.numpy(), gold["fs/attn/emb"].squeeze(1), **TOL)
    np.testing.assert_allclose(raw.numpy(), gold["fs/attn/raw"].squeeze(2), **TOL)


def test_saved_state_dict_loads_strictly(tmp_path):
    jcfg, cfg = configs(add_stain_encoding=True)
    model = port_model(cfg, jax_params(jcfg, seed=3))
    path = str(tmp_path / "model.pt")
    export_torch_checkpoint(model, path)
    _, loaded = create_model(cfg, checkpoint_path=path, device="cpu")
    x = to_torch(np.random.default_rng(3).standard_normal((2, 40, 64)).astype(np.float32))
    torch.testing.assert_close(port.encode(loaded, x, stain_idx=1),
                               port.encode(model, x, stain_idx=1), rtol=0, atol=0)
    fresh = MADELEINE(cfg)
    fresh.load_state_dict(torch.load(path), strict=True)


def test_create_model_from_pretrained_local_files(tmp_path):
    jcfg, cfg = configs()
    model = port_model(cfg, jax_params(jcfg, seed=4))
    export_torch_checkpoint(model, str(tmp_path / "model.pt"))
    cfg.save(str(tmp_path / "model_config.json"))
    cfg2, loaded, dtype = create_model_from_pretrained(str(tmp_path), download=False,
                                                       device="cpu")
    assert dtype == torch.float32 and cfg2.n_heads == cfg.n_heads
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


def test_fresh_init_is_seeded():
    _, cfg = configs()
    a = create_model(cfg, seed=7, device="cpu")[1].state_dict()
    b = create_model(cfg, seed=7, device="cpu")[1].state_dict()
    c = create_model(cfg, seed=8, device="cpu")[1].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["projector.weight"], c["projector.weight"])
