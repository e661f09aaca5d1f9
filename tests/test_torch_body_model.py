"""The port's body model against the JAX package's, in f32 on the CPU.

Tolerance: rtol 1e-5 (plus atol 1e-6 near zero), the f32 rounding of
the same algebra evaluated in a different operation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_torch.models import body_model as tbm
from bodyfitting_torch.ops.rotations import rodrigues
from tests.torch_port_util import arrays_of, torch_model


def _params(model, rng, batch):
    fields = {
        "betas": (model.num_betas, 0.5),
        "global_orient": (3, 0.6),
        "body_pose": (3 * model.num_body_joints, 0.3),
        "expression": (model.num_expressions, 0.4),
        "jaw_pose": (3, 0.1),
        "leye_pose": (3, 0.1),
        "reye_pose": (3, 0.1),
        "left_hand_pose": (model.num_hand_pca, 0.5),
        "right_hand_pose": (model.num_hand_pca, 0.5),
    }
    return {k: rng.normal(scale=s, size=(batch, n)).astype(np.float32)
            for k, (n, s) in fields.items()}


def _jax_forward(model, p, b):
    return jbm.forward(model, jbm.BodyParams(
        **{k: jnp.asarray(v[b]) for k, v in p.items()}))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("model_type", ["smplx", "smpl"])
def test_forward_matches_jax(rng, model_type):
    jm = jbm.synthetic_model(model_type, num_verts=384, seed=1)
    tm = torch_model(jm)
    p = _params(jm, rng, batch=2)
    out = tbm.forward(tm, tbm.BodyParams(
        **{k: torch.from_numpy(v) for k, v in p.items()}))
    for b in range(2):
        ref = _jax_forward(jm, p, b)
        _close(out.vertices[b], ref.vertices)
        _close(out.joints[b], ref.joints)
        _close(out.full_pose[b], ref.full_pose)


def test_reductions_match_jax(rng):
    jm = jbm.synthetic_model("smplx", num_verts=512, seed=2)
    tm = torch_model(jm)
    p = _params(jm, rng, batch=2)
    tp = tbm.BodyParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    ids = np.argsort(rng.random(512))[:100]
    jred, jrows = jbm.reduce_for_rows(jm, ids)
    tred, trows = tbm.reduce_for_rows(tm, ids)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    out_rows = tbm.forward(tred, tp)
    out_joints = tbm.forward(tbm.reduce_for_joints(tm), tp)
    jjoint = jbm.reduce_for_joints(jm)
    for b in range(2):
        full = _jax_forward(jm, p, b)
        _close(out_rows.vertices[b, trows], full.vertices[ids])
        _close(out_rows.joints[b], full.joints)
        _close(out_rows.vertices[b, trows],
               _jax_forward(jred, p, b).vertices[np.asarray(jrows)])
        _close(out_joints.joints[b], full.joints)
        _close(out_joints.joints[b], _jax_forward(jjoint, p, b).joints)


def test_rodrigues_zero_angle_value_and_gradient():
    aa = torch.zeros(4, 3, dtype=torch.float64, requires_grad=True)
    R = rodrigues(aa)
    np.testing.assert_allclose(R.detach().numpy(),
                               np.broadcast_to(np.eye(3), (4, 3, 3)),
                               atol=1e-12)
    (g,) = torch.autograd.grad(R[:, 0, 1].sum() + R[:, 2, 0].sum(), aa)
    assert torch.isfinite(g).all()
    # at 0, R ~ I + [aa]x: R01 = -aa_z and R20 = -aa_y
    from bodyfitting_tpu.ops.rotations import rodrigues as jrod

    jg = jax.grad(lambda a: jnp.sum(jrod(a)[:, 0, 1] + jrod(a)[:, 2, 0]))(
        jnp.zeros((4, 3)))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), [[0.0, -1.0, -1.0]] * 4, atol=1e-6)


@pytest.mark.parametrize("model_type,mesh", [("smplx", "random"),
                                             ("smpl", "sphere"),
                                             ("smplh", "random")])
def test_synthetic_model_same_arrays(model_type, mesh):
    jm = jbm.synthetic_model(model_type, num_verts=300, seed=5, mesh=mesh)
    tm = tbm.synthetic_model(model_type, num_verts=300, seed=5, mesh=mesh,
                             device="cpu")
    ja = arrays_of(jm)
    assert tm.tp_group is None          # the port's own field: not sharded
    for f in dataclasses.fields(tm):
        if f.name == "tp_group":
            continue
        tv, jv = getattr(tm, f.name), ja[f.name]
        if isinstance(tv, torch.Tensor):
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=f.name)
        else:
            assert tv == jv, f.name


@pytest.mark.parametrize("model_type", ["smpl", "smplh", "smplx"])
def test_smpl_to_openpose_matches_jax(model_type):
    for hands, face, contour in [(True, True, False), (True, True, True),
                                 (False, False, False)]:
        np.testing.assert_array_equal(
            tbm.smpl_to_openpose(model_type, hands, face, contour),
            jbm.smpl_to_openpose(model_type, hands, face, contour))
