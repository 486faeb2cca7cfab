"""Training in the port against the JAX reference, on the CPU: the loss
and gradients of the SSM (mamba2), hybrid (recurrentgemma: two RG-LRU
blocks and local attention over its window) and enc-dec (whisper: the
encoder over frames, the decoder with learned positions and
cross-attention) families.

The same checks and tolerances as ``test_torch_train.py`` (whose helpers
this module uses): reduced configs, the f32 loss within 1e-5 relative and
every f32 gradient leaf within 1e-4 of the leaf's largest magnitude (plus
1e-6 of the tree's largest gradient), the bf16 loss within 3e-2.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import numpy as np                                           # noqa: E402

from test_torch_train import (Family, check_family,          # noqa: E402
                              family_pair, one_thread)  # noqa: F401

FAMILIES = {
    "ssm": ("mamba2-1.3b", 2, None),
    # 3 layers: one superblock (R, R, A); a sequence of 32 against a
    # window cut to 8, so the band masks keys
    "hybrid": ("recurrentgemma-9b", 3,
               {"rglru": lambda r: dataclasses.replace(r, window=8)}),
    "encdec": ("whisper-medium", 1, None),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_and_gradients_match_reference(name):
    arch, n_layers, over = FAMILIES[name]
    check_family(*family_pair(arch, n_layers, over))


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """With a large step size (dt_bias = 6: softplus ~ 6, decay rates up
    to 16 a step) the intra-chunk exponent L_t - L_s above the diagonal
    passes f32's range. The reference masks after exp, so its gradient
    is 0 x inf = NaN there; the port masks the exponent first: the same
    loss, every gradient finite. Held as a difference (ROADMAP Queue 3)."""
    import jax
    import numpy as np

    from test_torch_train import Family
    fam = Family("mamba2-1.3b", 1)
    fam.jparams["blocks"]["ssd"]["dt_bias"] = \
        fam.jparams["blocks"]["ssd"]["dt_bias"] + 9.0
    with torch.no_grad():
        fam.tparams["blocks"][0]["ssd"]["dt_bias"] += 9.0
    want, jgrads = fam.jax_value_and_grad()
    got, tgrads = fam.port_value_and_grad()
    assert abs(got - want) <= 1e-5 * abs(want)
    assert not all(np.isfinite(g).all() for g in jax.tree.leaves(jgrads))
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(tgrads))
