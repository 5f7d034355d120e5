"""The port's training I/O against the JAX package's numpy-only modules, on the CPU.

COLMAP (binary and text), Blender `transforms.json` (with and without `w`/`h`) and
point-cloud PLY loaders: camera fields, points, colours and scene centre exactly equal to
`tpu_splat.io.{colmap,transforms,loader}`'s. Every COLMAP camera model through
`_camera_from_colmap`. `load_image` exactly equal to the JAX package's native lane
(`load_image_native`, libpng) for PNGs written by PIL (RGB, RGBA, grey, grey+alpha,
palette, 16-bit; PIL picks each row's filter) and by the port, under box factors 1, 2 and
3 and the bilinear long-side cap; PNGs carrying each of the five scanline filters equal
to PIL's decode; image sizes from the headers equal to PIL's. JPEG: the fixture's libjpeg
decode equals the native lane's, and the port's nvJPEG lane either raises naming what is
missing or (with a CUDA toolkit and card) agrees with libjpeg within 3/255 per channel.
`OptimizationParameters` field by field and both shipped presets, `split_cameras` and a
`Project` save/load/lock round trip.

Imports no JAX (the JAX package's modules used here import only numpy and PIL):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_io.py
"""

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tpu_splat.core import config as jax_config
from tpu_splat.core import project as jax_project
from tpu_splat.io import colmap as jax_colmap
from tpu_splat.io import loader as jax_loader
from tpu_splat.io import transforms as jax_transforms
from tpu_splat.io.native_loader import available as native_available
from tpu_splat.io.native_loader import load_image_native
from tpu_splat.training import dataset as jax_dataset
from tpu_splat_torch.core import config, project
from tpu_splat_torch.io import colmap, image, loader, nvjpeg, transforms
from tpu_splat_torch.io.ply import save_splat_ply
from tpu_splat_torch.ops.cameras import CameraParams
from tpu_splat_torch.training import dataset

from synth_data import make_raytraced_colmap, write_colmap_binary
from torch_fixtures import jpeg_fixture

REPO = Path(__file__).resolve().parents[1]
CAMERA_FIELDS = ("R", "T", "focal_x", "focal_y", "center_x", "center_y",
                 "radial_distortion", "tangential_distortion", "image_path", "image_name",
                 "uid", "camera_width", "camera_height", "image_width", "image_height")


def _same_cameras(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in CAMERA_FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            if isinstance(vb, np.ndarray):
                assert va.dtype == vb.dtype and np.array_equal(va, vb), f
            else:
                assert va == vb, f
        assert a.camera_model_type.name == b.camera_model_type.name
        assert a.requires_gut() == b.requires_gut()
        np.testing.assert_array_equal(a.world_view_transform, b.world_view_transform)
        np.testing.assert_array_equal(a.cam_position, b.cam_position)
        # the GUT path's CameraParams reads the port's Camera as the JAX one
        assert CameraParams.from_camera(a) == CameraParams.from_camera(b)


def _same_arrays(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 40x32 raytraced COLMAP capture, its OPENCV twin and a COLMAP text model."""
    base = tmp_path_factory.mktemp("io") / "rt"
    cams = make_raytraced_colmap(base, n_cams=5, size=40, height=32, seed=2, n_sfm=200)
    pts, cols = colmap._read_points3d_bin(base / "sparse" / "0" / "points3D.bin")
    cols = cols / 255.0
    opencv = base.parent / "opencv"
    opencv.mkdir()
    (opencv / "images").symlink_to(base / "images")
    write_colmap_binary(opencv, cams, pts, cols, camera_model="OPENCV",
                        distortion=(0.05, -0.01, 0.002, 0.001))
    text = base.parent / "text" / "sparse"
    text.mkdir(parents=True)
    (text.parent / "images").symlink_to(base / "images")
    models = ["PINHOLE", "SIMPLE_RADIAL", "OPENCV", "OPENCV_FISHEYE", "SIMPLE_PINHOLE"]
    extra = {"PINHOLE": [], "SIMPLE_RADIAL": [0.02], "OPENCV": [0.03, 0.0, 0.001, 0.0],
             "OPENCV_FISHEYE": [0.01, 0.002, 0.0, 0.0], "SIMPLE_PINHOLE": []}
    lines_c, lines_i = ["# cameras"], ["# images"]
    for i, c in enumerate(cams):
        model = models[i % len(models)]
        f = [c["fx"]] if model.startswith("SIMPLE") else [c["fx"], c["fy"]]
        params = f + [c["cx"], c["cy"]] + extra[model]
        lines_c.append(" ".join(map(str, [i + 1, model, c["width"], c["height"], *params])))
        q = np.array([0.9, 0.1 * i, -0.2, 0.3])
        q /= np.linalg.norm(q)
        lines_i.append(" ".join(map(str, [i + 1, *q, *c["T"], i + 1, c["name"]])))
        lines_i.append("")  # the 2D-point line
    (text / "cameras.txt").write_text("\n".join(lines_c) + "\n")
    (text / "images.txt").write_text("\n".join(lines_i) + "\n")
    (text / "points3D.txt").write_text("\n".join(
        f"{i + 1} {p[0]} {p[1]} {p[2]} {int(r)} {int(g)} {int(b)} 0.5"
        for i, (p, (r, g, b)) in enumerate(zip(pts[:50], (cols[:50] * 255).round()))) + "\n")
    return base, opencv, text.parent


@pytest.mark.parametrize("which", ["binary", "opencv", "text"])
def test_colmap_loader_matches_jax(capture, which):
    base = capture[("binary", "opencv", "text").index(which)]
    got = colmap.load_colmap(base, "images")
    want = jax_colmap.load_colmap(base, "images")
    _same_cameras(got[0], want[0])
    _same_arrays(got[1:], want[1:])
    res, ref = loader.load(base), jax_loader.load(base)
    assert res.loader_used == ref.loader_used == "colmap"
    _same_cameras(res.scene.cameras, ref.scene.cameras)
    _same_arrays((res.scene.points, res.scene.colors, res.scene.scene_center),
                 (ref.scene.points, ref.scene.colors, ref.scene.scene_center))


@pytest.mark.parametrize("model", [name for name, _ in jax_colmap.CAMERA_MODELS.values()])
@pytest.mark.parametrize("rc", [False, True])
def test_camera_from_colmap_matches_jax(model, rc):
    n = dict(jax_colmap.CAMERA_MODELS.values())[model]
    params = np.random.default_rng(len(model)).uniform(-0.1, 400.0, n)
    if model == "FOV":  # listed by COLMAP, unsupported by both packages
        with pytest.raises(ValueError, match="FOV"):
            colmap._camera_from_colmap(model, params, rc)
        return
    got = colmap._camera_from_colmap(model, params, rc)
    want = jax_colmap._camera_from_colmap(model, params, rc)
    assert got[:4] == want[:4] and got[6].name == want[6].name
    _same_arrays(got[4:6], want[4:6])


def _write_transforms(root: Path, capture_base: Path, with_size: bool) -> Path:
    imgs = sorted((capture_base / "images").glob("*.png"))
    frames = []
    for i, p in enumerate(imgs):
        ang = 2 * np.pi * i / len(imgs)
        c2w = np.eye(4)
        c2w[:3, 3] = [3 * np.sin(ang), 0.2, 3 * np.cos(ang)]
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        frame = {"file_path": f"images/{p.stem}", "transform_matrix": c2w.tolist()}
        if with_size and i % 2:
            frame.update(w=40, h=32, fl_x=30.0, cx=19.5)
        frames.append(frame)
    meta = {"camera_angle_x": 0.9, "frames": frames}
    if with_size:
        meta.update(w=40, h=32)
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "images").exists():
        (root / "images").symlink_to(capture_base / "images")
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("with_size", [False, True])
def test_transforms_loader_matches_jax(capture, tmp_path, with_size):
    root = _write_transforms(tmp_path / "blender", capture[0], with_size)
    got, want = transforms.load_transforms(root), jax_transforms.load_transforms(root)
    _same_cameras(got[0], want[0])
    _same_arrays(got[1:], want[1:])
    res, ref = loader.load(root), jax_loader.load(root)
    assert res.loader_used == ref.loader_used == "transforms"
    _same_arrays((res.scene.points, res.scene.colors, res.scene.scene_center),
                 (ref.scene.points, ref.scene.colors, ref.scene.scene_center))


def test_pointcloud_and_gaussian_ply_branches_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
             ("blue", "u1")]
    rows = np.empty(30, dtype)
    for i, k in enumerate("xyz"):
        rows[k] = pts[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rows[k] = cols[:, i]
    header = "ply\nformat binary_little_endian 1.0\nelement vertex 30\n" + "".join(
        f"property {'float' if t == '<f4' else 'uchar'} {n}\n" for n, t in dtype) + "end_header\n"
    cloud = tmp_path / "cloud.ply"
    cloud.write_bytes(header.encode() + rows.tobytes())
    res, ref = loader.load(cloud), jax_loader.load(cloud)
    assert res.loader_used == ref.loader_used == "ply_pointcloud"
    assert res.scene.cameras == []
    _same_arrays((res.scene.points, res.scene.colors, res.scene.scene_center),
                 (ref.scene.points, ref.scene.colors, ref.scene.scene_center))
    model = tmp_path / "model.ply"
    save_splat_ply(model, pts, rng.normal(size=(30, 1, 3)), np.zeros((30, 3, 3)),
                   rng.normal(size=(30, 3)), rng.normal(size=(30, 4)), rng.normal(size=(30, 1)))
    res, ref = loader.load(model), jax_loader.load(model)
    assert res.loader_used == ref.loader_used == "ply" and res.scene is None
    for k, v in ref.splat_params.items():
        np.testing.assert_array_equal(res.splat_params[k], v)


# ------------------------------------------------------------------------ images

def _require_native():
    if not native_available():
        pytest.skip("the JAX package's native loader (g++, libpng, libjpeg) does not "
                    "build on this machine")


def _pil_pngs(root: Path) -> list[Path]:
    rng = np.random.default_rng(5)
    out = []
    for mode in ("RGB", "RGBA", "L", "LA", "P", "I;16"):
        h, w = 37, 53
        noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        ramp = (np.linspace(0, 255, w)[None, :, None] * np.ones((h, 1, 4))).astype(np.uint8)
        arr = np.where(rng.random((h, w, 1)) < 0.3, noise, ramp)
        if mode == "I;16":
            im = Image.fromarray(arr[..., 0].astype(np.uint16) * 257 + 3)
        else:
            im = Image.fromarray(arr, "RGBA").convert(mode)
        p = root / f"pil_{mode.replace(';', '')}.png"
        im.save(p)
        out.append(p)
    img = rng.random((3, 31, 45)).astype(np.float32)
    image.save_image(str(root / "port.png"), img)  # the port's writer: filter 0
    return out + [root / "port.png"]


@pytest.mark.parametrize("resize_factor,max_width", [(1, 3840), (2, 3840), (3, 3840),
                                                     (1, 40), (2, 17), (3, 11)])
def test_load_image_png_matches_native_lane(tmp_path, resize_factor, max_width):
    _require_native()
    for p in _pil_pngs(tmp_path):
        want = load_image_native(str(p), resize_factor, max_width)
        got = image.load_image(p, resize_factor, max_width)
        assert got.dtype == want.dtype and got.shape == want.shape, p.name
        np.testing.assert_array_equal(got, want, err_msg=p.name)


def _filtered_png(rgb: np.ndarray, filters) -> bytes:
    """PNG bytes of uint8 [H, W, 3] with row y filtered by filters[y % len(filters)]
    (the forward filters of the PNG specification, written per byte)."""
    h, w, _ = rgb.shape
    px = rgb.reshape(h, w * 3).astype(np.int32)
    raw = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        raw.append(f)
        for i in range(w * 3):
            a = px[y, i - 3] if i >= 3 else 0
            b = px[y - 1, i] if y else 0
            c = px[y - 1, i - 3] if y and i >= 3 else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[f]
            raw.append((int(px[y, i]) - pred) % 256)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (image.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (1, 2), (4, 3, 2, 1, 0)])
def test_png_scanline_filters_decode_as_pil(tmp_path, filters):
    rgb = np.random.default_rng(sum(filters)).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    rgb[5:9] = np.linspace(0, 255, 17 * 3).reshape(17, 3).astype(np.uint8)
    data = _filtered_png(rgb, filters)
    np.testing.assert_array_equal(image.decode_png(data), rgb)
    p = tmp_path / "f.png"
    p.write_bytes(data)
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im), rgb)


def test_image_size_from_headers(tmp_path):
    for p in _pil_pngs(tmp_path):
        with Image.open(p) as im:
            assert image.image_size(p) == im.size
    jpg = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((21, 34, 3), np.uint8)).save(jpg, quality=80)
    assert image.image_size(jpg) == (34, 21)
    assert image.image_size(tmp_path / "port.png") == (45, 31)
    assert image.loaded_size(1296, 840, 2, 600) == (600, 389)


def _nvjpeg_ready() -> bool:
    import torch

    try:
        nvjpeg.cuda_home()
    except RuntimeError:
        return False
    return torch.cuda.is_available()


def test_jpeg_fixture_is_libjpegs_decode(tmp_path):
    _require_native()
    data, rgb = jpeg_fixture()
    p = tmp_path / "fixture.jpg"
    p.write_bytes(data)
    want = load_image_native(str(p))
    np.testing.assert_array_equal(rgb.transpose(2, 0, 1) * (np.float32(1) / np.float32(255)),
                                  want)


def test_jpeg_goes_to_nvjpeg_or_raises(tmp_path):
    """JPEG decodes only through nvJPEG: without the CUDA toolkit it raises and says so
    (no second decoder); with it, it agrees with libjpeg within 3/255 per channel."""
    data, rgb = jpeg_fixture()
    p = tmp_path / "fixture.jpg"
    p.write_bytes(data)
    if not _nvjpeg_ready():
        with pytest.raises(RuntimeError, match="nvJPEG"):
            image.load_image(p)
        return
    got = image.decode_file(p)
    assert np.abs(got.astype(np.int16) - rgb).max() <= 3


# ---------------------------------------------------------------- config, split, project


def test_optimization_parameters_match_jax():
    got, want = config.OptimizationParameters(), jax_config.OptimizationParameters()
    assert got.to_json() == want.to_json()
    for s in (0.5, 2.0):
        got_s = config.OptimizationParameters(steps_scaler=s).apply_steps_scaler()
        assert got_s.to_json() == jax_config.OptimizationParameters(
            steps_scaler=s).apply_steps_scaler().to_json()
    obj = dict(want.to_json(), iterations=123, no_such_key=1)  # unknown keys are dropped
    assert config.OptimizationParameters.from_json(obj).to_json() == \
        jax_config.OptimizationParameters.from_json(obj).to_json()
    assert config.DatasetConfig().__dict__ == jax_config.DatasetConfig().__dict__


@pytest.mark.parametrize("preset", sorted((REPO / "parameter").glob("*.json")),
                         ids=lambda p: p.stem)
def test_presets_load_as_in_jax(preset):
    got = config.OptimizationParameters.from_file(preset)
    want = jax_config.OptimizationParameters.from_file(preset)
    assert got.to_json() == want.to_json()
    assert got.config_file == str(preset)


def test_split_cameras_matches_jax(capture):
    cams = colmap.load_colmap(capture[0])[0] * 3
    for every in (0, 1, 3, 8):
        for split in ("all", "train", "val"):
            got = [c.uid for c in dataset.split_cameras(cams, every, split)]
            want = [c.uid for c in jax_dataset.split_cameras(cams, every, split)]
            assert got == want
    with pytest.raises(ValueError):
        dataset.split_cameras(cams, 3, "test")


def test_camera_dataset_sample(capture):
    cams = colmap.load_colmap(capture[0])[0]
    sample = dataset.CameraDataset(cams, resize_factor=2).get(1)
    assert sample.image.shape == (3, 16, 20) and sample.index == 1
    assert (sample.camera.image_width, sample.camera.image_height) == (20, 16)
    assert (sample.fx, sample.cx) == cams[1].intrinsics_for_size(20, 16)[::2]


def test_project_round_trip_and_lock(tmp_path):
    proj = project.create_new_project(str(tmp_path / "data"), str(tmp_path / "out"))
    assert proj.path == tmp_path / "out" / "out.ls"
    assert proj.acquire_lock()
    assert not project.Project.load(proj.path).acquire_lock()  # held by this process
    proj.params = {"iterations": 7}
    proj.add_ply("final", tmp_path / "out" / "splat_final.ply", iteration=7)
    back = project.Project.load(proj.path)
    ref = jax_project.Project.load(proj.path)  # the JAX package reads the port's file
    for p in (back, ref):
        assert (p.name, p.data_path, p.params, p.version) == ("out", str(tmp_path / "data"),
                                                              {"iterations": 7}, 2)
        assert [(r.name, r.iteration) for r in p.plys] == [("final", 7)]
    proj.release_lock()
    assert back.acquire_lock()
    back.release_lock()
    assert not back.lock_path.exists()
