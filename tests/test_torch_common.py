"""Kinematics and geometry of the PyTorch port vs mind_tpu on random inputs:
1e-12 in float64, 1e-6 in float32."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.common import geometry as tgeo
from mind_tpu_torch.common import kinematics as tkin

TOL = {"float64": 1e-12, "float32": 1e-6}


def _pair(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a, dtype), torch.tensor(a, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kinematics_match_jax(dtype):
    from mind_tpu.common.kinematics import ext_bicycle_step, kine_propagate

    rng = np.random.default_rng(0)
    state, ctrl = rng.normal(0, 3, (64, 4)), rng.normal(0, 4, (64, 2))
    js, ts = _pair(state, dtype)
    jc, tc = _pair(ctrl, dtype)
    np.testing.assert_allclose(tkin.kine_propagate(ts, tc, 0.02).numpy(),
                               np.asarray(kine_propagate(js, jc, 0.02)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    x, u = rng.normal(0, 2, (64, 6)), rng.normal(0, 1, (64, 2))
    x[:, 5] = rng.uniform(-0.5, 0.5, 64)
    jx, tx = _pair(x, dtype)
    ju, tu = _pair(u, dtype)
    np.testing.assert_allclose(tkin.ext_bicycle_step(tx, tu, 0.2, 2.5).numpy(),
                               np.asarray(ext_bicycle_step(jx, ju, 0.2, 2.5)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jacobians_match_jacfwd(dtype):
    import jax
    from mind_tpu.common.kinematics import ext_bicycle_step

    rng = np.random.default_rng(1)
    x, u = rng.normal(0, 2, (32, 6)), rng.normal(0, 1, (32, 2))
    x[:, 5] = rng.uniform(-0.5, 0.5, 32)
    jx, tx = _pair(x, dtype)
    ju, _ = _pair(u, dtype)
    f = lambda a, b: ext_bicycle_step(a, b, 0.2, 2.5)
    want_x = jax.vmap(jax.jacfwd(f, argnums=0))(jx, ju)
    want_u = jax.vmap(jax.jacfwd(f, argnums=1))(jx, ju)
    f_x, f_u = tkin.ext_bicycle_jacobians(tx, 0.2, 2.5)
    tol = TOL[dtype] * 10  # entries reach ~10, so 1 ulp of float32 is ~1e-6
    np.testing.assert_allclose(f_x.numpy(), np.asarray(want_x), rtol=tol, atol=tol)
    np.testing.assert_allclose(f_u.numpy(), np.asarray(want_u), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_polyline_distances_match_jax(dtype):
    import jax.numpy as jnp
    from mind_tpu.common.geometry import jx_point_segments_dist, jx_points_polyline_dist

    rng = np.random.default_rng(2)
    P = 40
    poly = np.cumsum(rng.normal(1, 1, (P, 2)), axis=0)
    poly[30:] = 1e6                        # padding
    poly[5] = poly[4]                      # a zero-length segment
    mask = np.arange(P) < 30
    pts = rng.normal(10, 15, (7, 5, 2))
    jp, tp = _pair(poly, dtype)
    jq, tq = _pair(pts, dtype)
    got = tgeo.points_polyline_dist(tq, tp, torch.tensor(mask))
    want = jx_points_polyline_dist(jq, jp, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL[dtype],
                               atol=TOL[dtype] * 100)  # distances reach ~100
    seg_mask = rng.random(P - 1) > 0.3
    got = tgeo.point_segments_dist(tq[0, 0], tp[:-1], tp[1:], torch.tensor(seg_mask))
    want = jx_point_segments_dist(jq[0, 0], jp[:-1], jp[1:], jnp.asarray(seg_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL[dtype],
                               atol=TOL[dtype] * 100)


def test_resample_polyline_matches():
    from mind_tpu.common.geometry import resample_polyline

    poly = np.cumsum(np.random.default_rng(3).normal(2, 1, (12, 2)), axis=0)
    for got, want in zip(tgeo.resample_polyline(poly, 1.0), resample_polyline(poly, 1.0)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("demo", ["demo_1", "demo_2", "demo_3", "demo_4"])
def test_configs_load_like_jax(demo):
    """The reference-format sim and planner JSON files load into the same
    values (the checkpoint path differs: the port reads its .npz archive)."""
    import dataclasses
    from pathlib import Path

    from mind_tpu import config as jcfg
    from mind_tpu_torch import config as tcfg

    root = Path(__file__).resolve().parent.parent
    sim_path = root / "configs" / f"{demo}.json"
    assert dataclasses.asdict(tcfg.SimConfig.from_json(sim_path)) == \
        dataclasses.asdict(jcfg.SimConfig.from_json(sim_path))
    plan_path = root / "mind_tpu" / "configs" / f"{demo}.json"
    got = dataclasses.asdict(tcfg.load_planner_config(plan_path))
    want = dataclasses.asdict(jcfg.load_planner_config(plan_path))
    assert got.pop("ckpt_path").endswith("scene_pred_demo_600.npz")
    want.pop("ckpt_path")
    assert want["net"].pop("use_pallas_fusion") is None
    assert got == want
