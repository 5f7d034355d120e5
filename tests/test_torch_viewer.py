"""The port's serving side on the CPU: the crop box, point-cloud mode and SH degree 4
against the JAX package, the web viewer's routes, and a training run under the live
viewer with the timelapse and SOG export.

Tolerances:
* `core/geometry.py`: transforms bit-equal to JAX's (the same numpy code); `contains` and
  the crop mask equal on points none of which lies within 1e-5 of a face of its box (the
  port tests in torch, float32 products summed in another order).
* SH degree 4: colours and the gradients of a weighted sum w.r.t. sh0, shN and the
  directions against `jax.grad` of JAX `sh_to_color`, rtol 1e-6 plus an atol of 1e-6 of
  the array's largest value (a band sums nine products that cancel, so a small result
  carries the rounding of its large terms; JAX's own eager and jitted colours differ by up
  to 0.4e-6 on this fixture), at active degrees 4, 3 and 2 of a 24-coefficient basis.
* `render_view` (crop box, SH degree 4) against JAX `render_view`, image and alpha atol
  1e-5, as `tests/test_torch_render.py` holds `rasterize`; one shape, so the JAX renderer
  compiles once. Point-cloud mode atol 5e-5: its dots are 0.004 of the scene's extent
  (under a pixel here), so their alpha moves by ~1.6 per pixel of offset, and the two
  packages' projected means differ by one float32 ulp (~4e-6 px at x ~ 32): alpha and
  colour differ by up to 1.3e-5 on this fixture, where JAX's own two blends (XLA and
  Pallas interpret) agree to 1.2e-7 and normal splats to 3e-6.
* The viewer's frames: the PNG decodes to exactly the quantized `render_view` image of
  the same camera (the same code path on the same device).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core import geometry as jgeo
from tpu_splat.io.ply import save_splat_ply as jax_save_splat_ply
from tpu_splat.ops.sh import sh_to_color as jax_sh_to_color
from tpu_splat.render import load_model as jax_load_model
from tpu_splat.render import render_view as jax_render_view
from tpu_splat_torch import cli, viewer
from tpu_splat_torch.core import geometry as tgeo
from tpu_splat_torch.io.image import decode_png
from tpu_splat_torch.ops.sh import sh_to_color
from tpu_splat_torch.render import load_model, look_at, render_view
from tpu_splat_torch.training import trainer
from tpu_splat_torch.utils import events as ev

from synth_data import make_raytraced_colmap
from utils import make_scene

W, H = 64, 48


# ------------------------------------------------------------------------- geometry


def _transforms(rng, n=6):
    out = []
    for _ in range(n):
        q = rng.normal(0, 1, 4).astype(np.float32)
        out.append((q, rng.normal(0, 2, 3).astype(np.float32)))
    return out


def test_euclidean_transforms_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 3, (50, 3)).astype(np.float32)
    ts = _transforms(rng)
    for (qa, ta), (qb, tb) in zip(ts, ts[1:]):
        a, b = tgeo.EuclideanTransform(qa, ta), tgeo.EuclideanTransform(qb, tb)
        ja, jb = jgeo.EuclideanTransform(qa, ta), jgeo.EuclideanTransform(qb, tb)
        np.testing.assert_array_equal(a.to_matrix(), ja.to_matrix())
        np.testing.assert_array_equal(a.compose(b).to_matrix(), ja.compose(jb).to_matrix())
        np.testing.assert_array_equal(a.inverse().to_matrix(), ja.inverse().to_matrix())
        np.testing.assert_array_equal(a.apply(pts), ja.apply(pts))
        m = ja.to_matrix()
        np.testing.assert_array_equal(tgeo.EuclideanTransform.from_matrix(m).rotation,
                                      jgeo.EuclideanTransform.from_matrix(m).rotation)
    box = tgeo.BoundingBox([-1, -2, -3], [1, 2, 4])
    np.testing.assert_array_equal(box.center, jgeo.BoundingBox([-1, -2, -3], [1, 2, 4]).center)
    np.testing.assert_array_equal(box.size, [2, 4, 7])


def _boxes_and_points(seed=1):
    """Oriented boxes and points, none of them within 1e-5 of a face of any box."""
    rng = np.random.default_rng(seed)
    boxes = []
    for q, t in _transforms(rng, 4):
        lo = rng.uniform(-2, -0.5, 3).astype(np.float32)
        boxes.append((lo, lo + rng.uniform(1, 3, 3).astype(np.float32), q, 0.25 * t))
    pts = rng.normal(0, 1.5, (4000, 3)).astype(np.float32)
    keep = np.ones(len(pts), bool)
    for lo, hi, q, t in boxes:
        local = jgeo.EuclideanTransform(q, t).apply(pts.astype(np.float64))
        keep &= np.min(np.minimum(np.abs(local - lo), np.abs(local - hi)), axis=1) > 1e-5
    return boxes, pts[keep]


def test_contains_and_crop_match_jax(tmp_path):
    boxes, pts = _boxes_and_points()
    scene = make_scene(len(pts), 2, sh_rest=0)
    scene["means"] = pts
    path = _ply_of(tmp_path, scene)
    state_j, state_t = jax_load_model(path), load_model(path, device="cpu")
    for lo, hi, q, t in boxes:
        jbox = jgeo.BoundingBox(lo, hi, jgeo.EuclideanTransform(q, t))
        tbox = tgeo.BoundingBox(lo, hi, tgeo.EuclideanTransform(q, t))
        want = jbox.contains(pts)
        assert 50 < want.sum() < len(pts) - 50
        np.testing.assert_array_equal(tbox.contains(torch.as_tensor(pts)).numpy(), want)
        cropped = tgeo.crop_splat_by_box(state_t, tbox)
        assert cropped.capacity == state_t.capacity
        np.testing.assert_array_equal(cropped.alive.numpy(),
                                      np.asarray(jgeo.crop_splat_by_box(state_j, jbox).alive))


def _ply_of(tmp, scene, name="m.ply"):
    path = tmp / name
    jax_save_splat_ply(path, scene["means"], scene["sh0"], scene["shN"], scene["scaling_raw"],
                       scene["rotation_raw"], scene["opacity_raw"])
    return path


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("models")


# ------------------------------------------------------------------------- SH degree 4


@pytest.mark.parametrize("degree", [4, 3, 2])
def test_sh_degree4_colours_and_gradients_match_jax(degree):
    rng = np.random.default_rng(degree)
    n = 300
    sh0 = rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32)
    shN = rng.normal(0, 0.2, (n, 24, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs[0] = 0.0  # a dead slot: the safe normalize
    w = rng.normal(0, 1, (n, 3)).astype(np.float32)

    def jloss(a, b, d):
        return jnp.sum(jax_sh_to_color(a, b, d, degree) * w)

    want = np.asarray(jax_sh_to_color(jnp.asarray(sh0), jnp.asarray(shN), jnp.asarray(dirs),
                                      degree))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(sh0), jnp.asarray(shN),
                                                jnp.asarray(dirs))
    leaves = [torch.tensor(x, requires_grad=True) for x in (sh0, shN, dirs)]
    got = sh_to_color(*leaves, degree)
    tgrads = torch.autograd.grad((got * torch.as_tensor(w)).sum(), leaves)
    for g_t, g_j in zip((got.detach(), *tgrads), (want, *jgrads)):
        g_t, g_j = g_t.numpy(), np.asarray(g_j)
        # row 0 (zero direction) has a 1e12-scale direction gradient: held relatively
        np.testing.assert_allclose(g_t[0], g_j[0], rtol=1e-6)
        scale = np.abs(g_j[1:]).max()
        np.testing.assert_allclose(g_t[1:], g_j[1:], rtol=1e-6, atol=1e-6 * scale)
    if degree < 4:
        assert not tgrads[1][:, 15:].any()  # band 4 is masked


# ------------------------------------------------------- render_view against JAX


def _orbit_w2c(theta=0.7, phi=-0.3, radius=3.5):
    center = np.array([0.0, 0.0, 5.0], np.float32)
    eye = center + radius * np.array([np.cos(theta) * np.cos(phi), np.sin(phi),
                                      np.sin(theta) * np.cos(phi)], np.float32)
    return look_at(eye.astype(np.float32), center)


@pytest.mark.parametrize("case", ["point_cloud", "crop", "sh4"])
def test_render_view_matches_jax(case, model_dir):
    path = model_dir / "sh4.ply"
    if not path.exists():
        _ply_of(model_dir, make_scene(500, 5, sh_rest=24), path.name)
    sj, st = jax_load_model(path), load_model(path, device="cpu")
    assert st.max_sh_degree == 4 and st.shN.shape[1] == 24
    kw = {}
    if case == "point_cloud":
        kw = dict(point_cloud=True)
    if case == "crop":
        lo, hi = np.array([-0.5, -1.0, 4.0], np.float32), np.array([1.0, 0.6, 6.0], np.float32)
        sj = jgeo.crop_splat_by_box(sj, jgeo.BoundingBox(lo, hi))
        st = tgeo.crop_splat_by_box(st, tgeo.BoundingBox(lo, hi))
        np.testing.assert_array_equal(st.alive.numpy(), np.asarray(sj.alive))
        assert 0 < int(st.n_alive()) < 400
    w2c = _orbit_w2c()
    want = jax_render_view(sj, w2c, W, H, **kw)
    got = render_view(st, w2c, W, H, device="cpu", **kw)
    img = got.image.numpy()
    assert img.shape == (3, H, W) and img.std() > 0.01
    atol = 5e-5 if case == "point_cloud" else 1e-5
    np.testing.assert_allclose(img, np.asarray(want.image), rtol=0, atol=atol)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=0, atol=atol)


# ------------------------------------------------------------------------- the viewer


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_viewer_routes_on_cpu(tmp_path):
    model = _ply_of(tmp_path, make_scene(300, 11, sh_rest=15))
    other = _ply_of(tmp_path, make_scene(200, 12, sh_rest=3), "other.ply")
    server = viewer.serve(str(model), port=0, width=W, height=H, compare_path=str(other),
                          device="cpu", block=False)
    v = server.viewer
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, ctype, body = _get(base, "/")
        assert status == 200 and ctype == "text/html"
        assert f'width="{W}" height="{H}"'.encode() in body and b"/scene_ctl" in body
        info = json.loads(_get(base, "/info")[2])
        assert info == dict(n_alive=300, width=W, height=H, compare=True, n_nodes=1)
        scene = json.loads(_get(base, "/scene")[2])
        assert scene["nodes"][0]["n"] == 300 and scene["crop"]["on"] is False

        def frame(query, **kw):
            status, ctype, png = _get(base, "/frame?" + query)
            assert status == 200 and ctype == "image/png"
            return decode_png(png)

        q = "theta=0.6000&phi=-0.2500&radius=1.0000"
        w2c = viewer.orbit_w2c(v.center, v.base_radius, 0.6, -0.25, 1.0)
        rgb = frame(q + "&mode=RGB")
        want = render_view(v.scene_state(), w2c, W, H, device="cpu").image
        np.testing.assert_array_equal(rgb, viewer.quantize(torch.clamp(want, 0, 1).numpy()))
        pc = frame(q + "&mode=PC")
        want = render_view(v.scene_state(), w2c, W, H, point_cloud=True, device="cpu").image
        np.testing.assert_array_equal(pc, viewer.quantize(torch.clamp(want, 0, 1).numpy()))
        overlay = frame(q + "&mode=RGB&overlay=1")
        assert (overlay != rgb).any()
        ed = frame(q + "&mode=RGB_ED")
        np.testing.assert_array_equal(ed[:, : W // 2], rgb[:, : W // 2])
        split = frame(q + "&mode=RGB&split=0.5")
        np.testing.assert_array_equal(split[:, : W // 2 - 1], rgb[:, : W // 2 - 1])
        assert (split[:, W // 2 - 1: W // 2 + 1] == 255).all()  # the divider

        lo = (v.center - 0.3 * v.base_radius).round(3)
        hi = (v.center + 0.3 * v.base_radius).round(3)
        ctl = f"/scene_ctl?crop=1&cmin={','.join(map(str, lo))}&cmax={','.join(map(str, hi))}"
        assert json.loads(_get(base, ctl)[2]) == {"ok": True}
        scene = json.loads(_get(base, "/scene")[2])
        assert scene["crop"]["on"] is True
        cropped = frame(q + "&mode=RGB")
        box = tgeo.BoundingBox(np.asarray(lo, np.float32), np.asarray(hi, np.float32))
        want = render_view(tgeo.crop_splat_by_box(v.nodes[0].state, box), w2c, W, H,
                           device="cpu").image
        np.testing.assert_array_equal(cropped, viewer.quantize(torch.clamp(want, 0, 1).numpy()))
        _get(base, "/scene_ctl?node=0&visible=1&ox=0.5&oy=0&oz=0")
        assert json.loads(_get(base, "/scene")[2])["nodes"][0]["offset"] == [0.5, 0.0, 0.0]
        with pytest.raises(urllib.error.HTTPError):
            _get(base, "/nothing")
        assert v.renders == 7 and len(v.frame_ms) == 6  # the split frame renders twice
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("viewer_capture")
    make_raytraced_colmap(base, n_cams=6, size=48, n_sfm=160)
    return base


def test_cli_trains_under_the_live_viewer_with_timelapse_and_sog(colmap_dir, tmp_path,
                                                                 monkeypatch, request):
    """24 iterations through `cli.main` without --headless, with --timelapse-images of two
    views every 8 iterations and --sog. The live viewer is attached on a free port; training
    is paused from the start, and a client reads /status and /frame, resumes, pauses again
    once the iterations have risen, and resumes."""
    names = sorted(p.name for p in (colmap_dir / "images").iterdir())[:2]
    servers, seen = [], {}
    attach = viewer.attach
    paused = threading.Event()  # set when the train loop has entered its pause
    unsubscribe = ev.when(ev.TrainingPaused, lambda e: paused.set())

    def attach_paused(t, **kw):
        servers.append(attach(t, width=W, height=H, **kw))
        ev.emit(ev.PauseTraining())
        return servers[-1]

    monkeypatch.setattr(viewer, "attach", attach_paused)
    kept, train = [], trainer.Trainer.train

    def recording_train(self, *a, **kw):
        kept.append(self)
        return train(self, *a, **kw)

    monkeypatch.setattr(trainer.Trainer, "train", recording_train)

    def client():
        while not servers:
            time.sleep(0.01)
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"

        def status():
            return json.loads(_get(base, "/status")[2])

        def wait(pred):
            for _ in range(30000):  # up to ~5 min on a loaded machine
                s = status()
                if pred(s):
                    return s
                time.sleep(0.01)
            raise TimeoutError(s)

        seen["page"] = _get(base, "/")[2]
        paused.wait(120)
        seen["first"] = status()
        seen["frame1"] = decode_png(_get(base, "/frame?theta=0.5&phi=-0.2&radius=1&mode=RGB")[2])
        paused.clear()
        _get(base, "/control?action=resume")
        wait(lambda s: s["iteration"] >= 10)
        _get(base, "/control?action=pause")
        paused.wait(120)
        seen["second"] = status()
        t = kept[0]
        w2c = viewer.orbit_w2c(servers[0].viewer.center, servers[0].viewer.base_radius, 0.5,
                               -0.2, 1.0)
        seen["want2"] = render_view(t.state.splat, w2c, W, H, device="cpu").image
        seen["frame2"] = decode_png(_get(base, "/frame?theta=0.5&phi=-0.2&radius=1&mode=RGB")[2])
        seen["pc"] = decode_png(_get(base, "/frame?theta=0.5&phi=-0.2&radius=1&mode=PC")[2])
        _get(base, "/control?action=resume")

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    request.addfinalizer(unsubscribe)
    cfg = tmp_path / "opt.json"
    cfg.write_text(json.dumps(dict(max_cap=256, refine_every=4, start_refine=2, stop_refine=20,
                                   save_steps=[], num_workers=1, scan_steps=4, sh_degree=3,
                                   sh_degree_interval=8)))
    out = tmp_path / "out"
    assert cli.main(["-d", str(colmap_dir), "-o", str(out), "--config", str(cfg), "-i", "24",
                     "--device", "cpu", "--port", "0", "--timelapse-images", *names,
                     "--timelapse-every", "8", "--sog"]) == 0
    thread.join(timeout=300)
    assert not thread.is_alive()
    (t,) = kept
    assert t.state.iteration == 25 and np.isfinite(t._loss_hist).all()
    assert b"/status" in seen["page"] and b"pause" in seen["page"]
    assert seen["first"]["paused"] and seen["second"]["paused"]
    assert seen["second"]["iteration"] > seen["first"]["iteration"] >= 1
    assert seen["second"]["total"] == 24 and seen["second"]["n_alive"] > 0
    np.testing.assert_array_equal(
        seen["frame2"], viewer.quantize(torch.clamp(seen["want2"], 0, 1).numpy()))
    assert seen["frame1"].shape == (H, W, 3) and (seen["pc"] != seen["frame2"]).any()
    assert t.viewer_renders == 3 and t.timelapse_renders == 6
    for name in names:
        stem = name.rsplit(".", 1)[0]
        frames = sorted(p.name for p in (out / "timelapse" / stem).iterdir())
        assert frames == ["000008.png", "000016.png", "000024.png"]
        img = decode_png((out / "timelapse" / stem / "000024.png").read_bytes())
        assert img.shape == (48, 48, 3) and img.std() > 1.0
    model = load_model(out / "splat_final.sog", device="cpu")
    assert int(model.n_alive()) == int(t.state.splat.n_alive()) and model.max_sh_degree == 3
    frame = render_view(model, _orbit_w2c(), W, H, device="cpu").image
    assert torch.isfinite(frame).all() and float(frame.std()) > 0.01
