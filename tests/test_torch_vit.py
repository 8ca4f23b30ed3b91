"""The port's ViT tower (`madeleine_torch/preprocessing/vit.py`) on the CPU
against the JAX package's: a small tower (32 px, patch 8, width 64, 2
layers, 4 heads, out 16) with and without its projection against
`vit_forward` at rtol 1e-4 / atol 1e-5 (f32); open_clip-style ``visual.*``
state dicts loaded strictly, equal to JAX's bridge; the on-device resize
within one uint8 level of cv2.INTER_LINEAR; `TorchViTEncoder` against
`JaxViTEncoder` at 1e-4 relative Frobenius."""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.preprocessing import vit as jax_vit
from madeleine_torch.preprocessing import vit
from tests.test_vit import _torch_vit

SMALL = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4, out_dim=16)


def _jax_params(cfg, seed=0):
    """JAX init as numpy, biases and LayerNorm affines perturbed so that
    every parameter's path is exercised."""
    params = jax.tree_util.tree_map(np.asarray, jax_vit.init_vit_params(jax.random.PRNGKey(seed),
                                                                         cfg))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("b", "bias"):
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "scale":
                tree[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    perturb(params)
    for b in params["blocks"]:
        perturb(b)
    return params


def _port(jcfg, params):
    cfg = vit.ViTConfig(**dataclasses.asdict(jcfg))
    model = vit.VisionTransformer(cfg)
    model.load_state_dict(vit.vit_params_from_jax(params), strict=True)
    return cfg, model.eval()


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("out_dim", [16, None])
def test_tower_against_vit_forward(out_dim):
    jcfg = jax_vit.ViTConfig(**dict(SMALL, out_dim=out_dim))
    params = _jax_params(jcfg)
    cfg, model = _port(jcfg, params)
    assert (model.proj is None) == (out_dim is None)
    imgs = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    for project in (True, False):
        want = np.asarray(jax.jit(jax_vit.vit_forward, static_argnames=("cfg", "project"))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(imgs), jcfg,
            project=project))
        with torch.no_grad():
            got = model(torch.from_numpy(imgs), project=project).numpy()
        assert got.shape == want.shape == (3, out_dim if project and out_dim else 64)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_open_clip_state_dict_loads_strictly(tmp_path):
    """_torch_vit's open_clip layout: the port's tower equals the torch model
    (a real conv) and JAX's bridge; the heads default to width // 64, as
    JAX's; a stray or missing ``visual.*`` key is refused."""
    ref = _torch_vit().eval()
    sd = {f"visual.{k}": v.detach() for k, v in ref.state_dict().items()}
    sd["text.token_embedding.weight"] = torch.zeros(3, 4)   # another tower's key: not read
    cfg, model = vit.vit_from_torch_state_dict(sd, heads=4)
    jcfg, jparams = jax_vit.vit_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, heads=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    imgs = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs)).numpy()
        want_torch = ref(torch.from_numpy(imgs.transpose(0, 3, 1, 2))).numpy()
    want_jax = np.asarray(jax.jit(jax_vit.vit_forward, static_argnames="cfg")(
        jparams, jnp.asarray(imgs), jcfg))
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want_torch, rtol=1e-4, atol=1e-5)

    assert vit.vit_from_torch_state_dict(sd)[0].heads == jax_vit.vit_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})[0].heads == 1
    torch.save(ref.state_dict(), str(tmp_path / "tower.pt"))
    cfg2, model2 = vit.load_torch_vision_tower(str(tmp_path / "tower.pt"), prefix="", heads=4)
    with torch.no_grad():
        np.testing.assert_array_equal(model2(torch.from_numpy(imgs)).numpy(), got)
    with pytest.raises(RuntimeError, match="Unexpected"):
        vit.vit_from_torch_state_dict(dict(sd, **{"visual.attn_pool.weight": torch.zeros(2)}),
                                      heads=4)
    with pytest.raises(RuntimeError, match="Missing"):
        vit.vit_from_torch_state_dict({k: v for k, v in sd.items() if "ln_post.bias" not in k},
                                      heads=4)


@pytest.mark.parametrize("src,dst", [(256, 224), (40, 32), (20, 32)])
def test_resize_within_one_level_of_cv2(src, dst):
    tiles = np.random.default_rng(src).integers(0, 256, (4, src, src, 3), dtype=np.uint8)
    got = vit.resize_uint8(torch.from_numpy(tiles), dst).numpy()
    want = np.stack([cv2.resize(t, (dst, dst), interpolation=cv2.INTER_LINEAR) for t in tiles])
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"resize {src}->{dst}: {np.mean(diff > 0):.4%} of values differ by one level")
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert diff.max() <= 1


def test_encoder_against_jax_encoder():
    """Tiles of 40 px for a 32-px tower: JAX resizes them with cv2; the port
    is fed cv2's resized tiles (1e-4 relative Frobenius) and its own resize
    runs beside; bf16 against f32 at the card's bar, 2e-2."""
    jcfg = jax_vit.ViTConfig(**SMALL)
    params = _jax_params(jcfg, seed=3)
    cfg, model = _port(jcfg, params)
    tiles = np.random.default_rng(4).integers(0, 256, (5, 40, 40, 3), dtype=np.uint8)
    want = jax_vit.JaxViTEncoder(jcfg, jax.tree_util.tree_map(jnp.asarray, params))(tiles)
    enc = vit.TorchViTEncoder(cfg, model, device="cpu")
    assert enc.dim == 16
    resized = np.stack([cv2.resize(t, (32, 32), interpolation=cv2.INTER_LINEAR) for t in tiles])
    got = enc(resized)
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 16)
    assert _rel_fro(got, want) <= 1e-4
    own = enc(tiles)
    assert own.shape == got.shape and np.isfinite(own).all()
    bf16 = vit.TorchViTEncoder(cfg, _port(jcfg, params)[1], dtype=torch.bfloat16, device="cpu")
    assert _rel_fro(bf16(resized), got) <= 2e-2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            vit.TorchViTEncoder(cfg, model)


def test_init_vit_regime():
    cfg = vit.ViTConfig(**SMALL)
    model = vit.init_vit(vit.VisionTransformer(cfg), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.equal(sd["ln_post.weight"], torch.ones(64))
    assert torch.equal(sd["transformer.resblocks.1.ln_2.bias"], torch.zeros(64))
    assert torch.equal(sd["transformer.resblocks.0.attn.in_proj_bias"], torch.zeros(192))
    fc = sd["transformer.resblocks.0.mlp.c_proj.weight"]   # [64, 256]: std 1/16
    assert abs(float(fc.std()) - 256 ** -0.5) < 0.01
    assert abs(float(sd["positional_embedding"].std()) - 64 ** -0.5) < 0.02
