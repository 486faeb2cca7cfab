"""The serving engine in drain mode on a mesh of gloo ranks against the
JAX reference's engine on one device (``NULL_CTX``), the same weights on
both sides (the reference's parameters through ``repro_torch.interop``),
reduced configs in float32, one request plan of two waves over 2 slots:

- qwen2-0.5b (``mode="drain"``), recurrentgemma (``mode="auto"``, which
  resolves to drain; prompts past the reduced window of 32, so the ring
  rolls at prefill) and mamba2 (``mode="drain"``) on (1, 2) and (2, 1)
  ("data", "model") meshes under sub_operator, and qwen2 and
  recurrentgemma on (1, 2) under operator_centric and
  sub_operator+seqkv: each rank's token streams exact, its host syncs
  (one per decode step), step counts and program calls
  (``serve_prefill_batch``, ``serve_decode_drain``) equal to the JAX
  engine's; on (2, 1) each data row runs its slot and the host reads
  both rows' tokens in the one sync.

The ranks of each mesh start once (a module fixture), one intra-op
thread each, while the reference runs here.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402

import torch_mesh_family_ranks as ranks                      # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.models import NULL_CTX, build_model as jbuild     # noqa: E402
from repro.runtime.serving import Request as JRequest        # noqa: E402
from repro.runtime.serving import ServingEngine as JEngine   # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from test_torch_mesh import to_numpy_tree                    # noqa: E402

EXECUTORS = {(1, 2): ("sub_operator", "operator_centric",
                      "sub_operator+seqkv"),
             (2, 1): ("sub_operator",)}


def jcfg(name):
    return jget(ranks.DRAIN_ARCHS[name][0]).reduced().replace(
        dtype="float32")


def ref_engine(name, params):
    cfg = jcfg(name)
    reqs = ranks.drain_requests(cfg, name, JRequest)
    eng = JEngine(jbuild(cfg), NULL_CTX, ranks.DRAIN_SLOTS,
                  ranks.DRAIN_PROMPT[name], max_new_cap=32,
                  mode=ranks.DRAIN_ARCHS[name][1])
    st = eng.run(params, reqs, max_steps=400)
    return ([r.generated for r in reqs], eng.host_syncs,
            {k: st[k] for k in ranks.DRAIN_KEYS},
            {k: v["calls"] for k, v in st["runtime"].items()})


@pytest.fixture(scope="module")
def run():
    params = {name: jax.jit(jbuild(jcfg(name)).init)(jax.random.key(40 + i))
              for i, name in enumerate(ranks.DRAIN_ARCHS)}
    trees = {name: to_numpy_tree(p) for name, p in params.items()}
    handles = {shape: launch(ranks.drain_rank, shape, ("data", "model"),
                             (trees, EXECUTORS[shape]), timeout_s=300)
               for shape in EXECUTORS}
    try:
        ref = {name: ref_engine(name, params[name])
               for name in ranks.DRAIN_ARCHS}
    finally:
        res = {shape: h.join() for shape, h in handles.items()}
    return ref, res


CASES = [(name, shape, ex) for shape, exs in EXECUTORS.items()
         for ex in exs for name in ranks.DRAIN_ARCHS
         if ex == "sub_operator" or name != "mamba2"]


@pytest.mark.parametrize(
    "name, shape, executor", CASES,
    ids=[f"{n}-{'x'.join(map(str, s))}-{e}" for n, s, e in CASES])
def test_drain_on_mesh_matches_reference_engine(run, name, shape, executor):
    ref, res = run
    want_streams, want_syncs, want_stats, want_calls = ref[name]
    assert want_stats["mode"] == "drain"
    assert want_stats["admissions"] == len(ranks.DRAIN_PLAN)
    for r in res[shape]:
        streams, syncs, stats, calls, mesh = r[(name, executor)]
        assert streams == want_streams
        assert syncs == want_syncs == want_stats["decode_steps"]
        assert stats == want_stats
        assert calls == want_calls
        assert calls["serve_prefill_batch"] == 2
        if shape == (1, 2):
            # the model axis carries the residual's and the logits'
            # collectives; one data row: the host reads its own rows
            assert mesh["bytes_total"] > 0 and mesh["control_calls"] == 0
        else:
            # two data rows: each sync and each prefill's first tokens
            # gather both rows over the control group
            assert mesh["control_calls"] == syncs + 2
