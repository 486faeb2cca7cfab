"""Serving on a (1, 4) ("data", "model") mesh of four gloo ranks against
the JAX reference on one device (reduced internlm2-1.8b in float32, the
reference's weights): a 4-wide model axis on 4 query heads and 2 KV
heads, so the KV heads drop to replicated and attention gathers q;

- prefill and teacher-forced decode under each executor equal the
  reference's within rtol/atol 2e-4, greedy tokens exact, and
  operator_centric moves at least sub_operator's collective bytes;
- split-KV serving through the WA backend with ``a_shards=4``, the four
  shards on the A domain's model axis (each rank holds one block of every
  slot's positions, only the (o, m, l) triples cross ranks), gives the
  token streams of the reference's colocated sequential walk on the
  reference's ragged plan (its case runs on (1, 8); four ranks keep the CPU
  load down).

The ranks start once (a module fixture), one intra-op thread each.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import numpy as np                                           # noqa: E402

import torch_mesh_ranks as ranks                             # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from test_torch_mesh import (B, EXECUTORS, S, STEPS, TOL,    # noqa: E402
                             jbuild, jcfg, ref_engine, ref_model,
                             to_numpy_tree)


@pytest.fixture(scope="module")
def run():
    cfg = jcfg(ranks.DENSE)
    params = jax.jit(jbuild(cfg).init)(jax.random.key(0))
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    handle = launch(ranks.mesh_1x4, (1, 4), ("data", "model"),
                    (to_numpy_tree(params), toks, S), timeout_s=300)
    try:
        ref = {"model": ref_model(cfg, params, toks),
               "engine": ref_engine(cfg, params, "colocated", ranks.RAGGED)}
    finally:
        res = handle.join()
    return ref, res


@pytest.mark.parametrize("executor", EXECUTORS)
def test_sharded_prefill_decode_matches_reference(run, executor):
    ref, res = run
    want, want_tok = ref["model"]
    for r in res:
        got, got_tok, _ = r["model"][executor]
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got_tok.numpy(), want_tok)


def test_operator_centric_moves_at_least_sub_operators_bytes(run):
    _, res = run
    oc = sum(r["model"]["operator_centric"][2] for r in res)
    so = sum(r["model"]["sub_operator"][2] for r in res)
    assert oc >= so > 0, (oc, so)


def test_split_kv_over_the_model_axis_matches_sequential_walk(run):
    ref, res = run
    want, want_syncs = ref["engine"]
    for r in res:
        streams, completed, syncs, mesh, programs = r["engine"]
        assert completed == 3
        assert streams == want
        assert syncs == want_syncs
        # the shards' statistics merged across the model axis
        assert mesh["bytes_per_site"]["kv_seq_merge"] > 0
        assert all(p.startswith("serve_wa_") for p in programs)
