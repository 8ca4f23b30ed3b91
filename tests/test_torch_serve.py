"""Port EmbeddingService on the CPU against JAX `encode` on the same padded
batch (rtol 1e-4 / atol 1e-5), plus one HTTP round trip."""

import io
import json
import urllib.request
from http.server import ThreadingHTTPServer
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madeleine_tpu.models import madeleine as mtm
from madeleine_torch.serve.server import EmbeddingService, make_handler
from tests.torch_port_helpers import configs, jax_params, port_model

BUCKETS = (32, 64, 128)


@pytest.fixture()
def service():
    jcfg, cfg = configs()
    params = jax_params(jcfg, seed=0)
    svc = EmbeddingService(port_model(cfg, params), buckets=BUCKETS, max_batch=8,
                           max_wait_ms=20.0, device="cpu")
    yield svc, jax.tree_util.tree_map(jnp.asarray, params), jcfg
    svc.close()


def _jax_padded(params, jcfg, bag, bucket):
    feats = np.zeros((1, bucket, bag.shape[1]), np.float32)
    feats[0, :len(bag)] = bag
    mask = np.arange(bucket)[None] < len(bag)
    return np.asarray(mtm.encode(params, jcfg, jnp.asarray(feats), mask=jnp.asarray(mask)))[0]


def _bucket(n):
    return next(b for b in BUCKETS if n <= b)


def test_encode_and_encode_many_match_jax(service):
    svc, params, jcfg = service
    rng = np.random.default_rng(0)
    bags = [rng.standard_normal((n, 64)).astype(np.float32) for n in (50, 7, 128, 90, 33)]
    got_one = svc.encode(bags[0])
    np.testing.assert_allclose(got_one, _jax_padded(params, jcfg, bags[0], _bucket(50)),
                               rtol=1e-4, atol=1e-5)
    got = svc.encode_many(bags)
    for bag, g in zip(bags, got):
        np.testing.assert_allclose(g, _jax_padded(params, jcfg, bag, _bucket(len(bag))),
                                   rtol=1e-4, atol=1e-5)
    stats = svc.stats()
    assert stats["slides"] == 6 and stats["requests"] == 6 and stats["embed_dim"] == 128


def test_bad_input_rejected(service):
    svc, _, _ = service
    with pytest.raises(ValueError):
        svc.encode(np.zeros((5, 3), np.float32))
    with pytest.raises(ValueError):
        svc.encode_many([np.zeros((5, 64), np.float32), np.zeros(5, np.float32)])


def test_http_roundtrip(service):
    svc, params, jcfg = service
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        bag = np.random.default_rng(1).standard_normal((40, 64)).astype(np.float32)
        buf = io.BytesIO()
        np.savez(buf, features=bag)
        req = urllib.request.Request(url + "/encode", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            emb = np.asarray(json.loads(r.read())["embedding"], np.float32)
        np.testing.assert_allclose(emb, _jax_padded(params, jcfg, bag, 64),
                                   rtol=1e-4, atol=1e-5)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            assert json.loads(r.read())["slides"] == 1
    finally:
        server.shutdown()
        server.server_close()
