"""Training in the port against the JAX reference, on the CPU: the
transformer families' loss and gradients, K3's backward, the attention's
gradient and three steps of the train step.

Reduced configs at 1-2 layers, float32 unless said otherwise; the port's
seeded parameters go to the reference's layout through
``interop.tree_to_numpy`` and the batches come from the reference's
``SyntheticLMData`` (numpy, seeded), so both sides see the same weights
and inputs. Tolerances:

- the loss (``ModelAPI.loss``) in float32 within 1e-5 of the reference's
  ``api.loss``, relative; in bfloat16 within 3e-2 (K3 and the attention
  keep f32 where the reference rounds to bf16: ROADMAP Queue 3);
- every gradient leaf against ``jax.grad`` of the reference's loss within
  1e-4 of the leaf's largest magnitude, plus 1e-6 of the tree's largest
  gradient: the key biases' true gradient is 0 (the softmax does not move
  when every score of a query shifts by q.b), so both sides hold rounding
  noise there;
- K3's backward (``FusedFFN``) against autograd of ``fused_ffn_ref`` and
  against ``jax.grad`` of the reference's FFN; ``flash_attention``'s
  autograd gradient against ``jax.grad`` of the reference's custom VJP:
  1e-5 of the largest magnitude (f32);
- three ``train_step``s against the same three steps composed from the
  reference's ``api.loss``, ``jax.value_and_grad``, ``cosine_lr`` and
  ``adamw_update``: losses within 1e-5 relative, parameters and moments
  within 1e-5 of each leaf's largest magnitude, the step counter equal.

The families' fixtures are built once per module; the port runs on one
intra-op thread while this module runs (restored after).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data.synthetic import SyntheticLMData as JaxData  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models import transformer as jtransformer         # noqa: E402
from repro.optim import adamw as jadamw                      # noqa: E402
from repro.quant.int8 import QuantizedTensor as JaxQT        # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import tree_to_numpy                # noqa: E402
from repro_torch.kernels.fused_ffn.ops import fused_ffn      # noqa: E402
from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref  # noqa: E402
from repro_torch.launch import train as ttrain               # noqa: E402
from repro_torch.launch import train_lm                      # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import transformer as ttransformer   # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.optim.adamw import adamw_init               # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten     # noqa: E402

B, S = 2, 32
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 3e-2
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6           # of the tree's largest gradient magnitude
FFN_RTOL = 1e-5
STEP_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port while this module runs (the
    suite's other workers keep the other cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared helpers (the families' file imports them)
# ---------------------------------------------------------------------------

def to_numpy_tree(tree):
    """A JAX tree as numpy: bf16 as f32 (exact), int8 weights as
    {"values", "scale"}."""
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def flat_numpy(tree, prefix=""):
    """{path: array} of a numpy tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_numpy(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def assert_trees_close(got, want, rtol, floor=0.0):
    """Leaf by leaf (numpy trees of one structure): |got - want| <= rtol x
    the leaf's max |want| + floor x the tree's max |want|."""
    got, want = flat_numpy(got), flat_numpy(want)
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values() if w.size)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.isfinite(g).all(), k
        err = float(np.abs(g - w).max()) if w.size else 0.0
        tol = rtol * float(np.abs(w).max() if w.size else 0) + floor * top
        assert err <= tol, (k, err, tol)


def _configure(cfg, overrides, **kw):
    """``cfg.replace`` with ``overrides``; a callable override maps the
    field's current value (a nested config)."""
    for k, v in (overrides or {}).items():
        kw[k] = v(getattr(cfg, k)) if callable(v) else v
    return cfg.replace(**kw)


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def jax_tree(tparams):
    """The port's parameters in the reference's layout (layers stacked),
    each leaf a JAX array in the port leaf's dtype: the same values on
    both sides."""
    def conv(tnode, nnode):
        if isinstance(tnode, dict):
            return {k: conv(tnode[k], nnode[k]) for k in tnode}
        if isinstance(tnode, list):         # a stacked layer list
            return conv(tnode[0], nnode)
        return jnp.asarray(nnode, dtype=_JNP[tnode.dtype])
    return conv(tparams, tree_to_numpy(tparams))


class Family:
    """One config on both sides: the port's seeded parameters (its own
    init, which is fast) and the same values in the reference's layout,
    both APIs, a batch (numpy, JAX and torch), at a compute dtype."""

    def __init__(self, arch, n_layers, dtype="float32", overrides=None):
        self.jcfg = _configure(JAX_REGISTRY[arch].reduced(), overrides,
                               dtype=dtype, n_layers=n_layers)
        self.tcfg = _configure(get_config(arch).reduced(), overrides,
                               dtype=dtype, n_layers=n_layers)
        self.japi = jax_build_model(self.jcfg)
        self.tapi = build_model(self.tcfg, device="cpu")
        self.tparams = self.tapi.init(0)
        self.jparams = jax_tree(self.tparams)
        self.batch = JaxData(self.jcfg, B, S, seed=3).batch_at(0)
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.tbatch = ttrain.batch_to_torch(self.batch, "cpu")

    def jax_loss(self):
        return float(jax.jit(lambda p, b: self.japi.loss(p, b, NULL_CTX))(
            self.jparams, self.jbatch))

    def jax_value_and_grad(self):
        f = jax.jit(jax.value_and_grad(
            lambda p, b: self.japi.loss(p, b, NULL_CTX)))
        loss, grads = f(self.jparams, self.jbatch)
        return float(loss), to_numpy_tree(grads)

    def port_value_and_grad(self):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(self.tparams)]
        loss = self.tapi.loss(tree_unflatten(self.tparams, leaves),
                              self.tbatch)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), tree_to_numpy(
            tree_unflatten(self.tparams, list(grads)))


def check_family(fam32, fam16):
    """The f32 loss and every gradient leaf, then the bf16 loss."""
    want, jgrads = fam32.jax_value_and_grad()
    got, tgrads = fam32.port_value_and_grad()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    assert_trees_close(tgrads, jgrads, GRAD_RTOL, GRAD_FLOOR)
    want16 = fam16.jax_loss()
    with torch.no_grad():
        got16 = float(fam16.tapi.loss(fam16.tparams, fam16.tbatch))
    assert np.isfinite(got16)
    assert abs(got16 - want16) <= BF16_LOSS_RTOL * abs(want16), (got16,
                                                                  want16)


def family_pair(arch, n_layers, overrides=None):
    return (Family(arch, n_layers, "float32", overrides),
            Family(arch, n_layers, "bfloat16", overrides))


# ---------------------------------------------------------------------------
# the transformer families: dense, MoE (with its aux loss), VLM
# ---------------------------------------------------------------------------

TRANSFORMER_FAMILIES = {
    "dense": ("qwen2-0.5b", 1, None),
    "moe": ("qwen3-moe-235b-a22b", 2, None),
    # the VLM with learned positions: the vision embeddings before the
    # text, positions over both, the loss over the text alone
    "vlm": ("internvl2-76b", 2, {"pos": "learned"}),
}


@pytest.fixture(scope="module")
def families():
    return {}


def _family(families, name):
    if name not in families:
        families[name] = family_pair(*TRANSFORMER_FAMILIES[name])
    return families[name]


@pytest.mark.parametrize("name", sorted(TRANSFORMER_FAMILIES))
def test_loss_and_gradients_match_reference(families, name):
    check_family(*_family(families, name))


def test_moe_aux_loss_matches_reference_and_enters_the_loss(families):
    """The load-balance loss summed over layers, as the reference's scan
    sums it, and the loss is ce + 0.01 x aux."""
    fam, _ = _family(families, "moe")
    _, jaux = jtransformer.forward_hidden(fam.jparams, fam.jbatch["tokens"],
                                          fam.jcfg, NULL_CTX, train=True)
    with torch.no_grad():
        x, aux = ttransformer.forward_train(fam.tparams,
                                            fam.tbatch["tokens"], fam.tcfg)
        ce = ttransformer.common.chunked_ce_loss(
            ttransformer.unembed_table(fam.tparams, fam.tcfg), x,
            fam.tbatch["labels"], chunk=S)
        loss = fam.tapi.loss(fam.tparams, fam.tbatch)
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    assert float(loss) == pytest.approx(float(ce) + 0.01 * float(aux),
                                        rel=1e-6)


def test_chunked_ce_loss_matches_reference_at_several_chunks():
    """Chunks of 4, 8 and the whole sequence give the reference's value;
    ``ce_chunk`` picks the reference's chunk."""
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(5)
    table = rng.standard_normal((97, 16)).astype(np.float32)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    labels = rng.integers(0, 97, (2, 24)).astype(np.int32)
    for chunk in (4, 8, 24):
        want = float(jcommon.chunked_ce_loss(
            jnp.asarray(table), jnp.asarray(x), jnp.asarray(labels),
            NULL_CTX, chunk=chunk))
        got = float(tcommon.chunked_ce_loss(
            torch.from_numpy(table), torch.from_numpy(x),
            torch.from_numpy(labels), chunk=chunk))
        assert abs(got - want) <= 1e-6 * abs(want), (chunk, got, want)
    for n in (24, 3840, 512, 1000, 7):
        assert tcommon.ce_chunk(n) == jcommon.ce_chunk(n)


# ---------------------------------------------------------------------------
# K3 with a gradient
# ---------------------------------------------------------------------------

def _ffn_inputs(R=24, D=40, F=72, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dtype)

    return (t(R, D), t(D, F, scale=D ** -0.5), t(D, F, scale=D ** -0.5),
            t(F, D, scale=F ** -0.5), t(R, D))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_backward_matches_autograd_of_plain_version(act, dtype):
    *args, dout = _ffn_inputs(dtype=dtype)
    a1 = [a.clone().requires_grad_(True) for a in args]
    out = fused_ffn(*a1, act=act)
    assert out.grad_fn is not None and "FusedFFN" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, a1, dout.to(torch.float32))
    a2 = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(fused_ffn_ref(*a2, act=act), a2,
                               dout.to(torch.float32))
    # bf16: both compute in f32 and round once to bf16 at the end
    rtol = FFN_RTOL if dtype == torch.float32 else 8e-3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        g, w = g.to(torch.float32), w.to(torch.float32)
        assert (g - w).abs().max() <= rtol * w.abs().max()


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_fused_ffn_backward_matches_jax_grad_of_reference_ffn(act):
    """The reference's training FFN is three einsums around the gated
    activation (no Pallas kernel): jax.grad of it at the same x, weights
    and output gradient."""
    x, wg, wu, wd, dout = _ffn_inputs(seed=1)
    cfg = JAX_REGISTRY["qwen2-0.5b"].reduced().replace(
        dtype="float32", act=act, d_model=40, d_ff=72)

    def ref(x_, wg_, wu_, wd_):
        p = {"w_gate": {"w": wg_}, "w_up": {"w": wu_}, "w_down": {"w": wd_}}
        out = jtransformer.ffn_apply(p, x_, cfg, NULL_CTX)
        return jnp.sum(out * jnp.asarray(dout.numpy()))

    want = jax.grad(ref, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a.numpy()) for a in (x, wg, wu, wd)))
    args = [a.clone().requires_grad_(True) for a in (x, wg, wu, wd)]
    got = torch.autograd.grad(
        fused_ffn(*args, act={"swiglu": "silu", "geglu": "gelu"}[act]),
        args, dout)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= FFN_RTOL * np.abs(w).max()


def test_fused_ffn_outside_autograd_is_the_plain_call():
    """No input needs a gradient (serving, inference mode): the wrapper's
    forward, no autograd node."""
    x, wg, wu, wd, _ = _ffn_inputs()
    out = fused_ffn(x, wg, wu, wd)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fused_ffn_ref(x, wg, wu, wd),
                               rtol=0, atol=0)
    with torch.no_grad():
        out = fused_ffn(x.requires_grad_(True), wg, wu, wd)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# the attention's gradient: autograd of the port's one masked softmax
# against the reference's custom VJP (blocks recomputed from the LSE)
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (Sq, Sk, Hq, Hkv, causal, window, chunk)
    "causal": (16, 16, 2, 2, True, 0, 8),
    "windowed": (16, 16, 4, 2, True, 5, 8),
    "non_causal": (16, 16, 2, 2, False, 0, 8),
    "gqa_g4": (16, 16, 8, 2, True, 0, 8),
    # Sq != Sk, neither a chunk multiple: the reference pads both and
    # masks the padded keys (kv_limit); cross-attention is non-causal
    "padded_cross": (5, 7, 4, 2, False, 0, 4),
    "padded_causal": (12, 12, 4, 2, True, 0, 8),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_attention_gradient_matches_reference_vjp(name):
    Sq, Sk, Hq, Hkv, causal, window, chunk = ATTN_CASES[name]
    rng = np.random.default_rng(7)
    hd = 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, Sq, Hq, hd), (2, Sk, Hkv, hd), (2, Sk, Hkv, hd)))
    do = rng.standard_normal((2, Sq, Hq, hd)).astype(np.float32)

    def ref(q_, k_, v_):
        o = jattn.flash_attention_padded(q_, k_, v_, causal, window, chunk,
                                         chunk)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_attention(*args, window=window, causal=causal)
    got = torch.autograd.grad(out, args, torch.from_numpy(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - w).max() <= FFN_RTOL * np.abs(w).max()


# ---------------------------------------------------------------------------
# three train steps against the reference's composition
# ---------------------------------------------------------------------------

def test_three_train_steps_match_reference_composition():
    """internlm2 (no q/k/v biases, so every leaf has a real gradient and
    AdamW's normalised update is the same on both sides), 1 layer."""
    fam = Family("internlm2-1.8b", 1)
    steps = 3
    jparams, jopt = fam.jparams, jadamw.adamw_init(fam.jparams)
    tparams, topt = fam.tparams, adamw_init(fam.tparams)
    data = JaxData(fam.jcfg, B, S, seed=11)
    @jax.jit
    def jstep(p, o, b):
        loss, grads = jax.value_and_grad(
            lambda p_: fam.japi.loss(p_, b, NULL_CTX))(p)
        lr = jadamw.cosine_lr(o.step, 3e-4, warmup=20,
                              total=max(steps, 100))
        return (loss, *jadamw.adamw_update(p, grads, o, lr=lr)[:2])

    for i in range(steps):
        b = data.batch_at(i)
        loss, jparams, jopt = jstep(jparams, jopt,
                                    {k: jnp.asarray(v) for k, v in
                                     b.items()})
        tparams, topt, info = ttrain.train_step(
            tparams, topt, ttrain.batch_to_torch(b, "cpu"),
            loss=fam.tapi.loss, steps=steps)
        assert abs(float(info["loss"]) - float(loss)) <= \
            STEP_RTOL * abs(float(loss))
    assert int(topt.step) == int(jopt.step) == steps
    assert_trees_close(tree_to_numpy(tparams), to_numpy_tree(jparams),
                       STEP_RTOL)
    assert_trees_close(tree_to_numpy(topt.mu), to_numpy_tree(jopt.mu),
                       STEP_RTOL)
    assert_trees_close(tree_to_numpy(topt.nu), to_numpy_tree(jopt.nu),
                       STEP_RTOL)


# ---------------------------------------------------------------------------
# the driver's refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_train_and_example_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("qwen2-0.5b", steps=1, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--steps", "1", "--batch", "1", "--seq", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "2", "--batch", "1", "--seq", "8"])
    _, opt, losses = ttrain.train("qwen2-0.5b", steps=1, batch=1, seq=8,
                                  device="cpu")
    assert int(opt.step) == 1 and np.isfinite(losses[0][1])


def test_train_refuses_int8_weights_and_multi_device():
    """The reference's train raises TypeError on an int8-weight config
    (jax.grad of int8 leaves); the port says so in a ValueError. Training
    on a mesh is ported: an executor needs a mesh, and the recurrent
    families train on one."""
    with pytest.raises(ValueError, match="int8 weights cannot be trained"):
        ttrain.train("llama2-7b", steps=1, batch=1, seq=8, device="cpu")
    with pytest.raises(ValueError, match="an executor needs a mesh"):
        ttrain.train("qwen2-0.5b", steps=1, batch=1, seq=8, device="cpu",
                     executor="sub_operator")
    with pytest.raises(SystemExit, match="need --mesh"):
        ttrain.main(["--executor", "sub_operator", "--device", "cpu"])
    # the recurrent families train on a mesh: one step on a (1, 2) mesh
    # of ranks gives a finite loss
    losses = ttrain.train_on_mesh((1, 2), "mamba2-1.3b", 1, 2, 8,
                                  device="cpu", timeout_s=300)
    assert len(losses) == 1 and np.isfinite(losses[0][1])


class _FakeMesh:
    """A (2, 2) mesh's shape, for calls that raise before any
    collective."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}
    devices_shape = (2, 2)
    size = 4
    rank = 0
    device = torch.device("cpu")


def test_example_config_stays_out_of_the_registry():
    from repro_torch.configs.registry import REGISTRY
    cfg = train_lm.dense_100m()
    assert (cfg.name, cfg.n_layers, cfg.d_model) == ("dense-100m", 8, 512)
    assert "dense-100m" not in REGISTRY
