"""The reference torch checkpoint layout in the port's weight bridge
(mind_tpu_torch/models/weights.py: reference_mapping, params_from_reference,
to_reference, try_load_torch_checkpoint) against the JAX package's
mind_tpu/models/weights.py::torch_to_flax.

A random reference-layout state dict is built from the port's mapping (the
reference layout of a seeded port network). torch_to_flax(strict=True)
accepts it, which checks its key set and shapes against the JAX package's
own table; the two packages then map it to the same parameters (to the
bit) and their forwards agree within 1e-5. Missing, extra and wrongly
shaped keys raise, as tests/test_weights.py checks for the JAX package."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig as TNetConfig
from mind_tpu_torch.models import weights as tw
from mind_tpu_torch.models.train import init_scene_pred, make_dummy_batch

TINY = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32, d_embed=32, d_rpe=32,
            n_scene_head=4, pred_len=12)
A, L = 4, 8
CPU = torch.device("cpu")


def flat(params):
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module", params=["bezier", "monomial"])
def case(request):
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred as jinit

    tcfg = TNetConfig(**TINY, param_out=request.param)
    jcfg = NetConfig(**TINY, param_out=request.param, use_pallas_fusion=False)
    ref = tw.to_reference(init_scene_pred(tcfg, seed=7, device="cpu").state_dict(), tcfg)
    _, template, _ = jinit(jcfg, A, L, seed=0)
    return tcfg, jcfg, ref, template


def test_jax_accepts_the_ports_reference_layout_and_maps_it_alike(case):
    from mind_tpu.models.weights import torch_to_flax

    tcfg, jcfg, ref, template = case
    jparams = torch_to_flax(ref, template, jcfg, strict=True)
    want = tw.params_from_flax(flat(jparams))
    got = tw.params_from_reference(ref, tcfg)
    assert set(got) == set(want)
    skipped = set(tw.unused_edge_params(tcfg))
    assert len(skipped) == 6
    for k in got:
        if k not in skipped:   # flax keeps its template there, the port fills 0 / 1
            assert torch.equal(got[k], want[k]), k
    # the port's own round trip
    assert set(tw.to_reference(got, tcfg)) == set(ref)
    for k, v in tw.to_reference(got, tcfg).items():
        assert torch.equal(v, ref[k]), k


def test_forwards_agree_on_reference_weights(case):
    import jax.numpy as jnp
    from mind_tpu.models.scene_pred import ScenePredNet, make_batched_apply
    from mind_tpu.models.weights import torch_to_flax

    tcfg, jcfg, ref, template = case
    jparams = torch_to_flax(ref, template, jcfg, strict=True)
    batch = make_dummy_batch(tcfg, 3, A, L, seed=2, device="cpu")
    inputs = [x.numpy() for x in batch[:7]]
    want = make_batched_apply(ScenePredNet(jcfg), jcfg)(jparams, *map(jnp.asarray, inputs))
    net = tw.load_scene_pred(tcfg, None, CPU)
    net.load_state_dict(tw.params_from_reference(ref, tcfg), strict=True)
    with torch.no_grad():
        got = net(*batch[:7])
    for g, w, name in zip(got, want, ("cls", "reg", "vel")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_strict_mapping_flags_missing_extra_and_bad_shapes(case):
    tcfg, _, ref, _ = case
    key = next(iter(ref))
    with pytest.raises(KeyError):
        tw.params_from_reference({k: v for k, v in ref.items() if k != key}, tcfg)
    extra = {**ref, "pred_scene.bogus.weight": torch.zeros(3)}
    with pytest.raises(ValueError, match="not consumed"):
        tw.params_from_reference(extra, tcfg)
    assert set(tw.params_from_reference(extra, tcfg, strict=False)) == set(
        tw.params_from_reference(ref, tcfg))
    with pytest.raises(ValueError, match="shape mismatch"):
        tw.params_from_reference({**ref, "pred_scene.cls.6.weight": torch.zeros(7, 7)}, tcfg)
    # a packed memory projection one block too wide
    mem = "fusion_net.fuse_scene.fusion.0.proj_memory.0.weight"
    wide = torch.zeros(ref[mem].shape[0], ref[mem].shape[1] + 32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tw.params_from_reference({**ref, mem: wide}, tcfg)
    # numpy arrays are taken as tensors are
    got = tw.params_from_reference({k: v.numpy() for k, v in ref.items()}, tcfg)
    assert all(torch.equal(got[k], v) for k, v in tw.params_from_reference(ref, tcfg).items())


def test_try_load_torch_checkpoint(case, tmp_path):
    tcfg, _, ref, _ = case
    assert tw.try_load_torch_checkpoint(str(tmp_path / "absent.ckpt"), tcfg) is None
    assert tw.try_load_torch_checkpoint(None, tcfg) is None
    want = tw.params_from_reference(ref, tcfg)
    for obj in ({"state_dict": ref, "epoch": 1}, ref):
        torch.save(obj, tmp_path / "ref.ckpt")
        got = tw.try_load_torch_checkpoint(str(tmp_path / "ref.ckpt"), tcfg)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    torch.save({"state_dict": {**ref, "x.weight": torch.zeros(1)}}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="not consumed"):
        tw.try_load_torch_checkpoint(str(tmp_path / "bad.ckpt"), tcfg)
