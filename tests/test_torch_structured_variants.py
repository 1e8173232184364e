"""The port's compile_structured variants of a three-level hierarchy --
the dense coarsest restriction R1 (``super_bricks=None``), the dense
mid format and ``mid_resident`` -- against the JAX package's
compile_structured (Pallas in interpret mode) and against each other, on
the port's own host setup product (hex_mesh(8), 2^3 bricks; for R1 also
4^3 bricks with superbricks 2^3 and coefficients from seed 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import compile_structured
from saamge_tpu_torch.ops.midsmooth import MidTileMisfit
from saamge_tpu_torch.solve import structured as TS
from tests.test_torch_structured_options import (ALL_F32, BF16, F32, _close,
                                                 _jax_solves, _jgeo,
                                                 _port_solves, _setup)

torch.set_num_threads(1)


# -- (b) the dense coarsest restriction ---------------------------------------


@pytest.mark.parametrize("against", ["superbricks", "jax_dense"])
def test_structured_coarsest_restriction_matches_dense(against):
    """super_bricks=None (dense R1) is the superbrick cycle's restriction:
    the same cycle as the port's superbrick tent blocks within 1e-5, and
    as the JAX dense-R1 cycle within 5e-4, with equal iterations."""
    ml, b, geo, supers = _setup(8, 4, 3, sb=2)
    h = compile_structured(ml, geo, **ALL_F32)
    assert h.R1 is not None and h.Rst1 is None and h.supers is None
    assert h.R1.shape == (ml.levels[1].tg_data.Ac.shape[0], h.n_flat)
    y, its, _ = _port_solves(h, b)
    if against == "superbricks":
        hs = compile_structured(ml, geo, supers, **ALL_F32)
        assert hs.Rst1 is not None and hs.R1 is None
        y_ref, its_ref, _ = _port_solves(hs, b)
        tol = 1e-5
    else:
        y_ref, its_ref, _ = _jax_solves(
            JS.compile_structured(ml, _jgeo(geo)), b)
        tol = 5e-4
    _close(y, y_ref, tol)
    assert its == its_ref


# -- (c) the dense mid format -------------------------------------------------


@pytest.fixture(scope="module")
def jax_dense_ref():
    """The JAX test_struct_layout_variants_match reference: dense mid,
    flat layout, f32."""
    ml, b, geo, _ = _setup(8, 2, 3)
    return _jax_solves(JS.compile_structured(
        ml, _jgeo(geo), mid_format="dense", fine_layout="flat"), b)


@pytest.mark.parametrize("mid_format", ["dense", "brickblock"])
def test_struct_layout_variants_match(mid_format, jax_dense_ref):
    ml, b, geo, _ = _setup(8, 2, 3)
    h = compile_structured(ml, geo, mid_format=mid_format, **ALL_F32)
    assert h.mid_route == ("dense" if mid_format == "dense" else "resident")
    if mid_format == "dense":
        n1 = ml.levels[0].tg_data.Ac.shape[0]
        assert h.A1_dense.shape == (n1, n1) and h.dinv1.shape == (n1,)
        assert h.R1.shape == (ml.levels[1].tg_data.Ac.shape[0], n1)
        assert h.A1_blocks is None and h.Rst1 is None
    y, its, _ = _port_solves(h, b)
    y_ref, its_ref, _ = jax_dense_ref
    _close(y, y_ref, 5e-4)
    assert its == its_ref


def test_struct_dense_mid_bf16_matches_jax():
    """A bf16 dense mid operator: x rounded to bf16, the product in f32,
    as the JAX jnp.dot with preferred_element_type=f32."""
    ml, b, geo, _ = _setup(8, 2, 3)
    h = compile_structured(ml, geo, mid_format="dense", smoother_dtype=F32,
                           rp_dtype=F32, mid_dtype=BF16, device="cpu")
    assert h.A1_dense.dtype == BF16
    y, its, _ = _port_solves(h, b)
    y_ref, its_ref, _ = _jax_solves(JS.compile_structured(
        ml, _jgeo(geo), mid_format="dense", mid_dtype=jnp.bfloat16), b)
    _close(y, y_ref, 1e-2)
    assert all(abs(a - c) <= 1 for a, c in zip(its, its_ref))


# -- (d) mid_resident ---------------------------------------------------------


def test_mid_resident_false_matches_auto():
    ml, b, geo, _ = _setup(8, 2, 3)
    h_auto = compile_structured(ml, geo, **ALL_F32)
    h = compile_structured(ml, geo, mid_resident=False, **ALL_F32)
    assert h_auto.mid_route == "resident" and h.mid_route == "packed"
    assert torch.equal(h.A1_blocks, h_auto.A1_blocks)
    y, its, _ = _port_solves(h, b)
    y_ref, its_ref, _ = _port_solves(h_auto, b)
    _close(y, y_ref, 1e-5)
    assert its == its_ref


@pytest.mark.parametrize("mid_resident", [None, True])
def test_mid_resident_on_misfit(mid_resident, monkeypatch):
    """A card whose blocks have too little shared memory for one tile:
    the default takes the packed passes, True raises."""
    ml, _, geo, _ = _setup(8, 2, 3)
    monkeypatch.setattr(TS, "card_limits", lambda device: (132, 1024))
    if mid_resident:
        with pytest.raises(MidTileMisfit):
            compile_structured(ml, geo, mid_resident=True, **ALL_F32)
    else:
        h = compile_structured(ml, geo, **ALL_F32)
        assert h.mid_route == "packed" and h.A1_blocks is not None


def test_mid_resident_true_fits():
    ml, _, geo, _ = _setup(8, 2, 3)
    h = compile_structured(ml, geo, mid_resident=True, **ALL_F32)
    h_auto = compile_structured(ml, geo, **ALL_F32)
    assert h.mid_route == "resident"
    assert torch.equal(h.A1_tiles, h_auto.A1_tiles)
