"""Chunked (scan) sequence alignment: CLI parity with frame mode."""

import numpy as np

from phovo_tpu.utils.trajectory import read_trajectory

from tests.test_tum_pipeline import tum_dir  # noqa: F401 (fixture)


def test_chunked_matches_frame_mode(tum_dir, tmp_path):
    from phovo_tpu.apps.phovo_vo import main

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "num_levels: 2\nmax_iterations: [8, 8]\nmin_gradient_norms: [1.0e-9, 1.0e-9]\n"
        "sampling: bilinear\n"
    )
    frame_out = tmp_path / "frame.txt"
    chunk_out = tmp_path / "chunk.txt"
    common = ["--config", str(cfg), "--dataset", str(tum_dir),
              "--intrinsics", "128,128,63.5,47.5", "--quiet"]
    assert main(common + ["--output", str(frame_out)]) == 0
    assert main(common + ["--output", str(chunk_out), "--chunk", "2"]) == 0
    a = read_trajectory(frame_out)
    b = read_trajectory(chunk_out)
    assert len(a) == len(b)
    np.testing.assert_allclose(a.positions, b.positions, atol=1e-5)
    np.testing.assert_allclose(a.quaternions, b.quaternions, atol=1e-5)


import pytest


@pytest.mark.parametrize("backend", ["ceres", "biobjective"])
def test_chunked_matches_frame_mode_other_backends(tum_dir, tmp_path, backend):
    """--chunk works for every backend (ceres/trust-region and bi-objective
    ship their own chunked sequence entries) and reproduces frame mode."""
    from phovo_tpu.apps.phovo_vo import main

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "num_levels: 2\nmax_iterations: [6, 6]\n"
        "min_gradient_norms: [1.0e-9, 1.0e-9]\nsampling: bilinear\n"
    )
    frame_out = tmp_path / f"frame_{backend}.txt"
    chunk_out = tmp_path / f"chunk_{backend}.txt"
    common = ["--config", str(cfg), "--dataset", str(tum_dir),
              "--intrinsics", "128,128,63.5,47.5", "--quiet",
              "--backend", backend]
    assert main(common + ["--output", str(frame_out)]) == 0
    assert main(common + ["--output", str(chunk_out), "--chunk", "2"]) == 0
    a = read_trajectory(frame_out)
    b = read_trajectory(chunk_out)
    assert len(a) == len(b)
    np.testing.assert_allclose(a.positions, b.positions, atol=1e-5)
    np.testing.assert_allclose(a.quaternions, b.quaternions, atol=1e-5)


def test_chunked_checkpoint_resume(tum_dir, tmp_path):
    """Interrupt a chunked run with --max-frames, resume from the
    checkpoint, and get the identical trajectory as one uninterrupted run
    (regression: --checkpoint/--resume were silently ignored with --chunk)."""
    from phovo_tpu.apps.phovo_vo import main

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "num_levels: 2\nmax_iterations: [8, 8]\n"
        "min_gradient_norms: [1.0e-9, 1.0e-9]\nsampling: bilinear\n"
    )
    full_out = tmp_path / "full.txt"
    part_out = tmp_path / "part.txt"
    ckpt = tmp_path / "ckpt.json"
    common = ["--config", str(cfg), "--dataset", str(tum_dir),
              "--intrinsics", "128,128,63.5,47.5", "--quiet", "--chunk", "2"]
    assert main(common + ["--output", str(full_out)]) == 0
    # interrupted run: 3 pairs, then resume for the rest
    assert main(common + ["--output", str(part_out),
                          "--checkpoint", str(ckpt), "--max-frames", "3"]) == 0
    assert ckpt.is_file()
    assert main(common + ["--output", str(part_out),
                          "--checkpoint", str(ckpt), "--resume"]) == 0
    a = read_trajectory(full_out)
    b = read_trajectory(part_out)
    assert len(a) == len(b)
    np.testing.assert_allclose(a.positions, b.positions, atol=1e-5)
    np.testing.assert_allclose(a.quaternions, b.quaternions, atol=1e-5)


def test_chunk_carry_accepts_uint8():
    """The carry frame may arrive in storage dtype like the chunk frames
    (regression: a uint8 carry entered at 0..255 against 0..1 frames and
    the chunk's first pair aligned garbage)."""
    import jax.numpy as jnp

    from phovo_tpu.models.analytic import align_sequence_chunk
    from phovo_tpu.ops.camera import Intrinsics
    from phovo_tpu.utils.config import PhovoConfig
    from phovo_tpu.utils.synthetic import make_pair

    intr = Intrinsics(
        np.float32(128.0), np.float32(128.0), np.float32(63.5), np.float32(47.5)
    )
    I0, D0, I1, D1, gt = make_pair(intr, shape=(96, 128))
    cfg = PhovoConfig(
        num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
        max_iterations=(8, 12), lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10,) * 2, sampling="bilinear",
    )
    u8 = lambda im: (np.asarray(im) * 255).astype(np.uint8)
    res_u8, _, _ = align_sequence_chunk(
        jnp.asarray(u8(I0)), jnp.asarray(D0, jnp.float32),
        jnp.asarray(u8(I1))[None], jnp.asarray(D1, jnp.float32)[None],
        intr, cfg, False, None,
    )
    res_f, _, _ = align_sequence_chunk(
        jnp.asarray(I0, jnp.float32), jnp.asarray(D0, jnp.float32),
        jnp.asarray(I1, jnp.float32)[None], jnp.asarray(D1, jnp.float32)[None],
        intr, cfg, False, None,
    )
    # u8 quantization costs a little accuracy but the pose must be the same
    np.testing.assert_allclose(
        np.asarray(res_u8.state[0]), np.asarray(res_f.state[0]), atol=2e-3
    )
    assert np.abs(np.asarray(res_u8.state[0]) - np.asarray(gt)).max() < 0.05
