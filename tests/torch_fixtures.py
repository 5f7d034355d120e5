"""Numpy fixtures shared by the PyTorch port's tests. Importing it imports neither JAX
nor the port; the helpers that build or read JAX states import JAX when called."""

import numpy as np


def blend_fixture():
    """The 6-tile unaligned-segment fixture of test_blend_kernel_variants_parity."""
    rng = np.random.default_rng(3)
    TS, GW, GH, CH = 16, 3, 2, 256
    n_rows, max_chunks = 12, 2
    N = n_rows * CH
    s = rng.uniform(1.0, 4.0, N)
    ca = 1 / (s * s)
    cc = 1 / (s * s * rng.uniform(0.5, 2.0, N))
    feats = np.stack(
        [rng.uniform(0, GW * TS, N), rng.uniform(0, GH * TS, N), ca,
         rng.uniform(-0.3, 0.3, N) * np.sqrt(ca * cc), cc,
         rng.uniform(0.1, 1.0, N)] + [rng.uniform(0, 1, N)] * 3
        + [rng.uniform(1, 10, N)], 1).astype(np.float32)
    flat = np.zeros((16, N + max_chunks * CH + 128), np.float32)
    flat[:10, :N] = feats.T
    count = np.asarray([512, 512, 500, 512, 100, 300], np.int32)
    seg_start = np.asarray([0, 512, 1024, 1524, 2036, 2136], np.int32)
    return flat, seg_start, count, dict(n_tiles=GW * GH, grid_w=GW, tile_size=TS)


def to_jax_bf16(t):
    """A torch bfloat16 tensor as a JAX bfloat16 array with the same bits."""
    import jax.numpy as jnp
    import torch

    return jnp.asarray(t.contiguous().view(torch.int16).numpy()).view(jnp.bfloat16)


def emission_runs(seed=0, n=700, long_run=1500):
    """Random contiguous emission runs over n Gaussians: short runs, empty runs and one
    very long run. -> (counts, start, end, total), int32 arrays and an int."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[rng.random(n) < 0.25] = 0
    counts[n // 3] = long_run
    counts[-3:] = 0  # the last owner is not the last Gaussian
    end = np.cumsum(counts).astype(np.int32)
    return counts, (end - counts).astype(np.int32), end, int(end[-1])


# A 32x24 JPEG written by PIL (quality 90, 4:4:4 chroma, so no upsampling filter enters
# the comparison) of `jpeg_fixture_source()`, and the libjpeg decode of it (the JAX
# package's native lane) stored as an int8 difference from that source, zlib + base64.
_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoMDAsKCwsNDhIQ"
    "DQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsNFBQUFBQUFBQUFBQUFBQUFBQU"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAARCAAYACADAREAAhEBAxEB/8QAHwAAAQUBAQEB"
    "AQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKB"
    "kaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1"
    "dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcF"
    "BAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5"
    "OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0"
    "tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD8/wDRfAv3"
    "f3f6VjCsc+XZrtqd7ovgX7v7v9K7oVj9Py7NdtTvdF8C/d/d/pXbCsfp2XZrtqd7ovgX7v7v9K74Vj9Oy7Nd"
    "tTj9F8C/d/d/pX5zCsf5aZdmu2p2EFj/AGZEttjGwdPrz/Wvi8zfNi5v0/JH+l3hdV9vwhgqnf2n/p2Z13gL"
    "Qv7amuvl3eVs/Xd/hXv8Nz5HV/7d/U8rxGxX1aeC8/af+2HrOi+Bfu/u/wBK++hWPkcuzTbU4/RfAv3f3f6V"
    "+dQrH+WmXZrtqd7ovgX7v7v9K7oVj9Oy7NdtTvdF8C/d/d/pXbCsfp2XZrtqd7ovgX7v7v8ASu+FY/T8uzXb"
    "U//Z"
)
_JPEG_LIBJPEG_DELTA_B64 = (
    "eNptVtuSIzsIA9yd+f+PPVVbmxgOknBnHnYqlXHTNhch5JhZWrpZWZZVf3qNJ4cFC3xgabvTUtjPhSfX/ZfY"
    "572nHyuxx0J+cNqjLPp1wekqxwoRfLWdkfpoYJvTW691HE5xFtGDPn1Z+PiM9tAL5EwLNsISE5alICmLhGdn"
    "gScnPBrrdWSABHvREZxl98OiN5RKYGrs84TjjEufWDAuUJvwiY8JzzYki0Pc8hxsEFOYB+EzZtDv5psomZ3M"
    "GKYdqE5VsCZ/HHdCp/4FDjnRZfCBxNXriT59RH7BNNV0n/0oNOzUJ5SHEPDEztnuapjlxjFFKVIEfW0PqX2n"
    "G9yT2vPk04v9lAefQJqZR9rg1l9proWw8dJx9WXxlfoIHPLgwNN45QISXAqBw5KRC/pVNThYvrL+e33ubJ8r"
    "m2q1VjTdm3s7/e7D9zv+/OyNDPLtF6FM8bHLeXDoXhXJv+rhczvxn0/9ib1ydSH/9v+J98qdhq+6bQo9fFBJ"
    "7I84OWyYtvjPtrfnVZdndIPkv4ev/W+74D8XUst4of8/KEOsxxSqz3I7XHGQth7eXts+SLt3L/kncXtk4B+o"
    "sfjCwG7zGz2dif7OkViM2QbNxCtfajFSg6khSgzJjYHDyLfPG4IAKvgHX9kgiUfd4BiicV58QtJQkjhN1obr"
    "tQst6NrDXpDBpErZvSr7VUT8BQyfzRHTLDw+R2i+vB3Oa2fPwlpX+2ycIQJ197pRAtXqgn/P29c7PFqcNHxe"
    "PsL7aNR3rgWSOM9gjcgNJ1//jf4FlPK6kMB+dXEZy3JtjYawNXa27V112NF/O/j4pCB7xaNU0jreCy6ucYqP"
    "EEnHmvilK0RqyFaO/otR0n8xCpJdI4lxStM2xbW5FyYO52j0HxfB0B495QURv3j71Yri1SAJOKoycyRsWd8v"
    "bN2lJ7pB1NMvb0cKUaikH3LGMmHgHNXR/DryP3vmPnL6FGKT/8KbUo0+GBQ13KRUw2efi2t8uc3Ac2yle/of"
    "gwOTUh+JKDmWpXvHj7bTTvf1616owe9UNBPLCfJzH+XJZ9vRf8xCSf/1o0F3H/wGfx7IzpBcj/5L2HT9TIta"
    "AFjic8XPLIBT9vS6MPerfvXUptd+VID6/52jEPn/B9k1jQk="
)


def jpeg_fixture_source():
    """The uint8 [24, 32, 3] image the fixture JPEG encodes: gradients and a red box."""
    ys, xs = np.mgrid[0:24, 0:32]
    img = np.stack([xs * 8, ys * 10, (xs + ys) * 4], -1).astype(np.float32)
    img[8:16, 10:20] = [250, 40, 30]
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_fixture():
    """-> (JPEG file bytes, libjpeg's RGB decode of them as uint8 [24, 32, 3])."""
    import base64
    import zlib

    delta = np.frombuffer(zlib.decompress(base64.b64decode("".join(_JPEG_LIBJPEG_DELTA_B64))),
                          np.int8).reshape(24, 32, 3)
    rgb = (jpeg_fixture_source().astype(np.int16) + delta).astype(np.uint8)
    return base64.b64decode("".join(_JPEG_B64)), rgb


def jax_state_fields(ts_j) -> dict:
    """The keyword fields of `tpu_splat_torch.convert.train_state_from_numpy` for a JAX
    TrainState, as numpy arrays: the splat, Adam, the iteration, the densification info
    and the optional components (those that are None stay out)."""
    import jax

    nd = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    fields = dict(
        splat_params=nd(ts_j.splat.params()), alive=np.asarray(ts_j.splat.alive),
        exp_avg=nd(ts_j.adam.exp_avg), exp_avg_sq=nd(ts_j.adam.exp_avg_sq),
        step_count={k: int(v) for k, v in ts_j.adam.step_count.items()},
        iteration=int(ts_j.iteration), max_sh_degree=ts_j.splat.max_sh_degree,
        scene_scale=ts_j.splat.scene_scale, dens_count=np.asarray(ts_j.dens_count),
        dens_grad2d=np.asarray(ts_j.dens_grad2d))

    def aux(o):
        return dict(m=jax.tree.map(np.asarray, o.m), v=jax.tree.map(np.asarray, o.v),
                    count=int(o.count))

    if ts_j.bilateral_grids is not None:
        fields.update(bilateral_grids=np.asarray(ts_j.bilateral_grids),
                      bilateral_opt=aux(ts_j.bilateral_opt))
    if ts_j.pose_params is not None:
        fields.update(pose_params=jax.tree.map(np.asarray, ts_j.pose_params),
                      pose_opt=aux(ts_j.pose_opt))
    if ts_j.admm is not None:
        fields["admm"] = dict(u=np.asarray(ts_j.admm.u), z=np.asarray(ts_j.admm.z))
    return fields


def jax_splat(n=120, capacity=256, seed=7):
    """A JAX SplatState of `n` points in front of the camera at z = 5 with anisotropic
    scales and tilted rotations (isotropic splats have an identically zero rotation
    gradient)."""
    import dataclasses

    import jax.numpy as jnp

    from tpu_splat.core.splat import init_from_pointcloud

    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] += 5
    cols = rng.random((n, 3)).astype(np.float32)
    state = init_from_pointcloud(pts, cols, np.array([0, 0, 5.0]), capacity=capacity)
    q = rng.normal(0, 0.5, (capacity, 4)).astype(np.float32)
    q[:, 0] += 2.0
    scaling = np.asarray(state.scaling_raw) + rng.normal(0, 0.4, (capacity, 3)).astype(
        np.float32)
    return dataclasses.replace(state, rotation_raw=jnp.asarray(q),
                               scaling_raw=jnp.asarray(scaling))


def recorded_grads():
    """A context manager that records what each `torch.autograd.grad` call inside it
    returns (a list of gradient tuples), so a test reads the gradients a port train step
    took without taking them again."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def recorder():
        calls, grad = [], torch.autograd.grad

        def wrapped(*args, **kwargs):
            out = grad(*args, **kwargs)
            calls.append(out)
            return out

        torch.autograd.grad = wrapped
        try:
            yield calls
        finally:
            torch.autograd.grad = grad

    return recorder()


def check_params_like_jax(ts_t, ts_j, compared: dict, lrs: dict, n_steps: int) -> None:
    """The splat parameters after `n_steps` train steps of each package, as
    `tests/test_torch_train_step.py::test_train_step_matches_jax` holds them: Adam's first
    steps move a parameter by lr * sign(g) wherever |g| is tiny against its history, so
    entries are compared only where the port's gradient exceeded 1e-6 of the group's
    largest at every step (`compared`), within 4e-3 of the group's learning rate per step;
    shN, frozen for the first 1000 iterations, exactly."""
    for k, mask in compared.items():
        want = np.asarray(getattr(ts_j.splat, k))
        got = getattr(ts_t.splat, k).numpy()
        if k == "shN":
            np.testing.assert_array_equal(got, want)
            continue
        mask = mask.numpy()
        assert mask.mean() > 0.05, k  # dead slots have no gradient
        np.testing.assert_allclose(got[mask], want[mask], rtol=0,
                                   atol=4e-3 * lrs[k] * n_steps + 1e-7, err_msg=k)
