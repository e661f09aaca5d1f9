"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the GPU unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "bodyfitting_tpu")


def _port_sources():
    files = [os.path.join(REPO, n)
             for n in ("chip_smoke.py", "bench_icp_kernels.py",
                       "bench_bilinear_kernel.py", "bench_skin_kernels.py")]
    for root, _, names in os.walk(os.path.join(REPO, "bodyfitting_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_jax_import_in_port_sources():
    files = _port_sources()
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, bodyfitting_torch, chip_smoke\n"
        "from bodyfitting_torch import convert\n"
        "from bodyfitting_torch.fitting import body_fitting, smplify, "
        "texture\n"
        "from bodyfitting_torch.losses import keypoints, mesh, priors, "
        "silhouette\n"
        "from bodyfitting_torch.models import hmr, inpaint\n"
        "from bodyfitting_torch.ops import kernels, nearest, rasterize, sdf\n"
        "from bodyfitting_torch.ops.kernels import skinning\n"
        "from bodyfitting_torch.utils import observability, uv_unwrap\n"
        "from bodyfitting_torch.apps import genebody, renderpeople\n"
        "from bodyfitting_torch.fitting import sequence\n"
        "from bodyfitting_torch.io import cameras, images, jpeg, obj, "
        "openpose, params, png, scan_prep\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'bodyfitting_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    from bodyfitting_torch import default_device
    from bodyfitting_torch.convert import fit_params_from_numpy
    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import texture as tf
    from bodyfitting_torch.losses.priors import synthetic_gmm_prior
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.models.inpaint import Inpainter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eye = [np.eye(4, dtype=np.float32)]
    K = [np.eye(3, dtype=np.float32)]
    calls = [
        lambda: default_device(),
        lambda: bm.synthetic_model("smplx", num_verts=64),
        lambda: synthetic_gmm_prior(),
        lambda: bf.build_observations(eye, K, [None], True),
        lambda: fit_params_from_numpy({}, np.zeros(3), np.ones(1)),
    ]
    # the texture stage
    quad = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tri = np.array([[0, 1, 2]])
    uv = np.full((1, 3, 2), 0.5, np.float32)
    tex = np.zeros((4, 4, 3), np.float32)
    calls += [
        lambda: tf.render_scan_views(quad, tri, uv, tex, imgsize=8,
                                     viewnum=1),
        lambda: tf.fit_texture(quad, tri, uv, quad, tri, uv, tex),
        lambda: tf.rasterize_uv_atlas(uv, 8),
        lambda: tf.atlas_coverage_mask(uv, 8),
        lambda: tf.bake_displacement_map(uv, tri, quad, 8),
        lambda: tf.inpaint_unseen(tex, np.ones((4, 4), bool)),
        lambda: tf.render_compare((quad, tri, uv, tex), (quad, tri, uv, tex),
                                  "never_written", viewnum=1, imgsize=8),
        lambda: Inpainter(),
    ]
    # the GeneBody app and what it loads
    from bodyfitting_torch.apps import genebody as app

    args = app.config_parser().parse_args([])
    calls += [
        lambda: app.Runner(args),
        lambda: app.main([]),
        lambda: app.load_body_model(args),
        lambda: app.load_prior(args),
        lambda: bm.load_model("missing.npz"),
        lambda: bf.HMRBundle.load("missing.pth"),
    ]
    # the RenderPeople app
    from bodyfitting_torch.apps import renderpeople as rp

    rp_args = rp.config_parser().parse_args([])
    calls += [lambda: rp.Runner(rp_args), lambda: rp.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert default_device("cpu") == torch.device("cpu")
    assert bm.synthetic_model("smpl", num_verts=64, device="cpu").device \
        == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper serves CPU tensors with its plain version and nothing
    else: tensors elsewhere than on the CPU or one CUDA device raise
    instead of falling back."""
    from bodyfitting_torch.ops import kernels as K

    meta = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.bilinear_cov_grads(meta, torch.empty((1, 3, 2), device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        K.rows_scatter_add(torch.zeros((1, 3), dtype=torch.int32),
                           torch.empty((1, 3, 2), device="meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        K.nearest_d2_idx(torch.empty((2, 3), device="meta"),
                         torch.empty((1, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        K.rasterize_zbuf(torch.empty((1, 3, 2), device="meta"),
                         torch.empty((1, 3), device="meta"), 8)
    with pytest.raises(ValueError, match="different devices"):
        K.rasterize_attrs(torch.zeros((1, 3, 2)), torch.ones((1, 3)),
                          torch.empty((1, 3, 2), device="meta"), 8)
    K.reset_launch_counts()
    K.contour_match_full(torch.zeros(1, 2, 2), torch.zeros(1, 3, 2),
                         torch.ones(1, 3), torch.ones(1, 3))
    K.nearest_d2_idx(torch.zeros(2, 3), torch.ones(1, 3, 3))
    K.rasterize_zbuf(torch.zeros(1, 3, 2), torch.ones(1, 3), 8)
    K.rasterize_attrs(torch.zeros(1, 3, 2), torch.ones(1, 3),
                      torch.ones(1, 3, 2), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        K.skin_forward(torch.empty((5, 3), device="meta"),
                       torch.empty((1, 3, 12), device="meta"),
                       torch.empty((1, 5, 3), device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        K.skin_backward(torch.ones((5, 3)), torch.ones((1, 3, 12)),
                        torch.ones((1, 5, 3)),
                        torch.empty((1, 5, 3), device="meta"))
    K.fused_skinning(torch.ones((5, 3)), torch.ones((1, 3, 12)),
                     torch.ones((1, 5, 3), requires_grad=True)).sum().backward()
    assert K.launch_counts() == {"bilinear_cov_grads": 0,
                                 "contour_match_full": 0,
                                 "rows_scatter_add": 0,
                                 "nearest_d2_idx": 0,
                                 "rasterize_zbuf": 0,
                                 "rasterize_attrs": 0,
                                 "skin_forward": 0,
                                 "skin_backward": 0}


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card the smoke exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
