"""Keyframe tracking, loop closure, and pose-graph finalization."""

import numpy as np
import pytest

from phovo_tpu.datasets.tum import RGBDFrame
from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic
from phovo_tpu.models.keyframe import KeyframeVisualOdometry
from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.parallel.mesh import make_mesh
from phovo_tpu.utils.config import PhovoConfig
from phovo_tpu.utils.synthetic import render_plane

INTR = Intrinsics(np.float32(128.0), np.float32(128.0), np.float32(63.5), np.float32(47.5))
SHAPE = (96, 128)

CFG = PhovoConfig(
    num_levels=2,
    blur_filter_sizes=(0, 0),
    gradient_scales=(0.0625, 0.0625),
    max_iterations=(10, 12),
    lambda_steps=(1.0, 1.0),
    min_gradient_norms=(1e-10, 1e-10),
    sampling="bilinear",
)


def _out_and_back_states(n=9, reach=0.24):
    """Camera states going out along +x (with slight yaw) and returning."""
    half = n // 2
    xs = np.concatenate([np.linspace(0, reach, half + 1), np.linspace(reach, 0.02, n - half - 1)])
    states = []
    for k, x in enumerate(xs):
        states.append(np.array([x, 0.01 * np.sin(k), 0.0, 0.05 * x, 0.0, 0.0]))
    return states


@pytest.fixture(scope="module")
def loop_sequence():
    frames = []
    gt_poses = []
    for k, st in enumerate(_out_and_back_states()):
        T = np.asarray(se3.pose_matrix(st))
        I, D = render_plane(INTR, SHAPE, T)
        frames.append(
            RGBDFrame(
                timestamp=float(k),
                depth_timestamp=float(k),
                intensity=(I * 255).astype(np.uint8),
                depth=D,
            )
        )
        gt_poses.append(np.linalg.inv(T))  # camera-in-world
    return frames, gt_poses


def _make_kvo():
    vo = PhotoconsistencyOdometryAnalytic(CFG)
    vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
    return KeyframeVisualOdometry(
        vo,
        kf_translation=0.08,
        kf_rotation=0.1,
        loop_radius=0.15,
        loop_min_gap=2,
        loop_weight=50.0,
    )


def test_keyframes_promoted_and_tracked(loop_sequence):
    frames, gt_poses = loop_sequence
    kvo = _make_kvo()
    tracked = list(kvo.run(frames))
    assert len(tracked) == len(frames) - 1
    assert len(kvo.keyframes) >= 3  # motion crosses the threshold repeatedly
    assert len(kvo.odometry_edges) == len(kvo.keyframes) - 1
    # tracked poses close to ground truth (synthetic, low drift)
    for tf, gt in zip(tracked, gt_poses[1:]):
        assert np.linalg.norm(tf.pose[:3, 3] - gt[:3, 3]) < 0.02


def test_loop_closure_found_and_finalize_improves(loop_sequence):
    frames, gt_poses = loop_sequence
    kvo = _make_kvo()
    list(kvo.run(frames))
    # the trajectory returns near the start -> at least one loop closure
    assert len(kvo.loop_closures) >= 1
    lc = kvo.loop_closures[0]
    assert lc.to_kf - lc.from_kf >= 2
    assert lc.mean_residual < 0.05

    before = [tf.pose.copy() for tf in kvo.tracked]
    tracked = kvo.finalize(iterations=8)
    err_before = np.mean(
        [np.linalg.norm(p[:3, 3] - gt[:3, 3]) for p, gt in zip(before, gt_poses[1:])]
    )
    err_after = np.mean(
        [
            np.linalg.norm(tf.pose[:3, 3] - gt[:3, 3])
            for tf, gt in zip(tracked, gt_poses[1:])
        ]
    )
    # synthetic data has tiny drift; finalization must not degrade and must
    # keep the loop consistent
    assert err_after <= err_before + 1e-4
    final_pose = tracked[-1].pose
    assert np.linalg.norm(final_pose[:3, 3] - gt_poses[-1][:3, 3]) < 0.02


def test_finalize_on_mesh_matches_single_device(loop_sequence):
    frames, _ = loop_sequence
    kvo1 = _make_kvo()
    list(kvo1.run(frames))
    kvo2 = _make_kvo()
    list(kvo2.run(frames))
    t1 = kvo1.finalize(iterations=5)
    mesh = make_mesh(8, pixel_parallel=2)
    t2 = kvo2.finalize(mesh=mesh, iterations=5)
    for a, b in zip(t1, t2):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-4)


def test_finalize_with_photometric_ba(loop_sequence):
    """finalize(ba_iterations>0) runs the windowed photometric refinement
    and must not degrade the (already accurate) synthetic trajectory."""
    frames, gt_poses = loop_sequence
    kvo = _make_kvo()
    list(kvo.run(frames))
    tracked = kvo.finalize(iterations=8, ba_iterations=4, ba_window=4, ba_grid=6)
    err = np.mean(
        [
            np.linalg.norm(tf.pose[:3, 3] - gt[:3, 3])
            for tf, gt in zip(tracked, gt_poses[1:])
        ]
    )
    assert err < 0.02, err
    for tf in tracked:
        assert np.all(np.isfinite(tf.pose))


def test_photometric_ba_fixes_perturbed_keyframes(loop_sequence):
    """Deliberately corrupt the keyframe poses after tracking; the
    photometric refinement must pull them back toward ground truth using
    only the stored keyframe images."""
    frames, gt_poses = loop_sequence
    kvo = _make_kvo()
    list(kvo.run(frames))
    if len(kvo.keyframes) < 3:
        pytest.skip("not enough keyframes promoted")
    rng = np.random.default_rng(0)
    gt_kf = {k.index: k.pose.copy() for k in kvo.keyframes}
    for k in kvo.keyframes[1:]:
        d = rng.normal(0.0, 0.008, 6)
        k.pose = k.pose @ np.asarray(se3.pose_matrix(d))
    err_before = np.mean(
        [np.linalg.norm(k.pose[:3, 3] - gt_kf[k.index][:3, 3]) for k in kvo.keyframes]
    )
    kvo._refine_photometric(None, iterations=6, window=4, grid=6, damping=1e-4)
    err_after = np.mean(
        [np.linalg.norm(k.pose[:3, 3] - gt_kf[k.index][:3, 3]) for k in kvo.keyframes]
    )
    assert err_after < err_before / 2, (err_before, err_after)


def test_loop_closure_uses_predicted_init(loop_sequence):
    """Loop candidates with a LARGE relative transform (close positions,
    different viewpoints) must align from the predicted relative pose, not
    from zero — zero-init converges to a wrong basin there (regression)."""
    del loop_sequence
    vo = PhotoconsistencyOdometryAnalytic(CFG)
    vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
    # loop_min_gap=0: candidates are keyframes[:index - gap], i.e. the pair
    # (0, 1) qualifies only with zero gap
    kvo = KeyframeVisualOdometry(vo, loop_min_gap=0, loop_radius=0.5)

    # two keyframes sharing a position region but rotated/translated enough
    # that a zero-init direct alignment would not recover the transform
    st_a = np.zeros(6)
    st_b = np.array([0.12, -0.04, 0.02, 0.12, 0.05, 0.0])
    from phovo_tpu.models.keyframe import Keyframe

    for idx, st in ((0, st_a), (1, st_b)):
        T_cam = np.asarray(se3.pose_matrix(st))
        I, D = render_plane(INTR, SHAPE, T_cam)
        kvo.keyframes.append(
            Keyframe(
                index=idx, frame_index=idx, timestamp=float(idx),
                intensity=(I * 255).astype(np.uint8), depth=D,
                pose=np.linalg.inv(T_cam),
            )
        )
    kvo._try_loop_closure(kvo.keyframes[-1])
    assert len(kvo.loop_closures) == 1
    rel_true = kvo.keyframes[0].pose
    rel_true = np.linalg.inv(rel_true) @ kvo.keyframes[1].pose
    rel = kvo.loop_closures[0].relative
    assert np.linalg.norm(rel[:3, 3] - rel_true[:3, 3]) < 5e-3


def test_loop_closure_consistency_gate(loop_sequence):
    """A measured loop edge deviating wildly from the predicted relative
    pose (wrong-basin alignment) must be rejected even if it looks
    photometrically plausible (regression: such edges dragged the graph)."""
    frames, _ = loop_sequence
    kvo = _make_kvo()
    list(kvo.run(frames))
    n_before = len(kvo.loop_closures)

    class BogusResult:
        state = np.array([0.5, 0.4, 0.0, 0.8, 0.0, 0.0], np.float32)
        iterations = np.array([1, 1])
        cost = np.array([1e-6, 1e-6])
        num_valid = np.array([SHAPE[0] * SHAPE[1]] * 2, np.float32)

    kvo._align = lambda *a, **k: BogusResult()  # perfect-looking, wrong pose
    kvo._try_loop_closure(kvo.keyframes[-1])
    assert len(kvo.loop_closures) == n_before  # all bogus edges rejected


def test_level_skipping_config_does_not_promote_every_frame(loop_sequence):
    """Regression: with a level-skipping schedule (the shipped presets run
    no iterations at level 0), num_valid counts pixels at the finest level
    that RAN; the keyframe overlap fraction must be taken against that
    level's pixel count, not the full frame's — otherwise overlap reads
    ~1/4^level and EVERY frame is promoted to a keyframe."""
    frames, _ = loop_sequence
    cfg = PhovoConfig(
        num_levels=2,
        blur_filter_sizes=(0, 0),
        gradient_scales=(0.0625, 0.0625),
        max_iterations=(0, 12),  # level 0 skipped, like the shipped presets
        lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10, 1e-10),
        sampling="bilinear",
    )
    vo = PhotoconsistencyOdometryAnalytic(cfg)
    vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
    kvo = KeyframeVisualOdometry(
        vo, kf_translation=0.15, kf_rotation=0.2, loop_min_gap=3
    )
    list(kvo.run(frames))
    # the sequence moves ~0.06/frame at peak: nothing near every-frame
    assert len(kvo.keyframes) < len(frames) / 2, len(kvo.keyframes)


@pytest.mark.parametrize("chunk", [3, 16])
def test_run_chunked_matches_run(loop_sequence, chunk):
    """Chunked keyframe tracking on the serial warm-start chain
    (levelmajor='off') must reproduce the per-frame path exactly: same
    promotions, edges, loop closures, and tracked poses."""
    frames, _ = loop_sequence
    ref = _make_kvo()
    tracked_ref = list(ref.run(frames))
    kvo = _make_kvo()
    tracked = list(kvo.run_chunked(frames, chunk=chunk, levelmajor="off"))

    assert len(tracked) == len(tracked_ref)
    assert [k.frame_index for k in kvo.keyframes] == [
        k.frame_index for k in ref.keyframes
    ]
    assert len(kvo.loop_closures) == len(ref.loop_closures)
    assert [(i, j) for i, j, _ in kvo.odometry_edges] == [
        (i, j) for i, j, _ in ref.odometry_edges
    ]
    for a, b in zip(tracked, tracked_ref):
        assert a.frame_index == b.frame_index
        assert a.keyframe_index == b.keyframe_index
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-5)


def test_batched_deferred_closures_match_serial(loop_sequence):
    """The async batched closure dispatch (one vmapped align_batch per new
    keyframe, gated lazily) must find the same loop closures with the same
    relative transforms as the serial per-candidate fallback path."""
    frames, _ = loop_sequence
    ref = _make_kvo()
    # force the serial per-candidate path: pretend the backend has no
    # batched-closure context
    ref._analytic_batch_context = lambda: None
    list(ref.run(frames))
    assert not ref._pending_closures

    kvo = _make_kvo()
    list(kvo.run(frames))
    kvo.flush_loop_closures()

    assert len(ref.loop_closures) >= 1  # the fixture loops back
    assert [(lc.from_kf, lc.to_kf) for lc in kvo.loop_closures] == [
        (lc.from_kf, lc.to_kf) for lc in ref.loop_closures
    ]
    for a, b in zip(kvo.loop_closures, ref.loop_closures):
        np.testing.assert_allclose(a.relative, b.relative, atol=1e-5)
        assert abs(a.mean_residual - b.mean_residual) < 1e-5


def test_run_chunked_storage_depth_matches_metric(loop_sequence):
    """Storage-dtype streaming (uint16 depth counts + on-device conversion,
    the raw-replay keyframe path) must reproduce the metric-float path:
    counts * scale on device equals the host conversion bit-for-bit for
    these exactly-representable values' f32 product ordering."""
    import dataclasses

    frames, _ = loop_sequence
    scale = 1.0 / 5000.0
    storage = [
        dataclasses.replace(
            f,
            depth=np.clip(
                np.asarray(f.depth, np.float64) / scale + 0.5, 0, 65535
            ).astype(np.uint16),
        )
        for f in frames
    ]
    # the metric reference sees the SAME quantized depth (u16 round trip)
    metric = [
        dataclasses.replace(
            s, depth=s.depth.astype(np.float32) * np.float32(scale)
        )
        for s in storage
    ]
    ref = _make_kvo()
    tracked_ref = list(ref.run_chunked(metric, chunk=4))
    kvo = _make_kvo()
    tracked = list(kvo.run_chunked(storage, chunk=4, depth_scale=scale))

    assert [k.frame_index for k in kvo.keyframes] == [
        k.frame_index for k in ref.keyframes
    ]
    assert len(tracked) == len(tracked_ref)
    for a, b in zip(tracked, tracked_ref):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-6)
    # promoted keyframes store METRIC depth regardless of stream dtype
    for k in kvo.keyframes:
        assert k.depth.dtype == np.float32
        assert float(k.depth.max()) < 100.0


def test_finalize_pg_solver_cg_matches_dense(loop_sequence):
    """Pipeline-level pin (VERDICT r3 item 1): the keyframe pipeline's
    finalize with the matrix-free CG pose-graph solver must reproduce the
    dense solver's trajectory on the same tracked sequence."""
    frames, _ = loop_sequence
    dense = _make_kvo()
    dense.pg_solver = "dense"
    list(dense.run(frames))
    t_dense = dense.finalize()

    cg = _make_kvo()
    cg.pg_solver = "cg"
    list(cg.run(frames))
    t_cg = cg.finalize()

    assert len(t_cg) == len(t_dense)
    assert len(cg.loop_closures) == len(dense.loop_closures)
    for a, b in zip(t_cg, t_dense):
        np.testing.assert_allclose(a.pose, b.pose, atol=2e-4)


def test_finalize_exports_ba_landmark_map(loop_sequence, tmp_path):
    """finalize(ba_iterations>0) must populate the BA-refined landmark map
    (both scopes), and the landmarks must lie on the synthetic scene's
    plane (n.p = d — an exact geometric oracle); save_ply writes a valid
    ASCII PLY of them."""
    from phovo_tpu.utils.viz import save_ply

    frames, _ = loop_sequence
    for scope in ("window", "global"):
        kvo = _make_kvo()
        list(kvo.run(frames))
        kvo.finalize(ba_iterations=2, ba_scope=scope, ba_covis=3)
        assert kvo.map_points is not None and len(kvo.map_points) > 20, scope
        assert len(kvo.map_intensity) == len(kvo.map_points)
        n = np.array([0.06, -0.04, 1.0])
        d = np.abs(kvo.map_points @ n - 2.0) / np.linalg.norm(n)
        # plane-distance oracle: median landmark within ~2 cm of the
        # true surface (render_plane plane_normal/plane_d defaults)
        assert float(np.median(d)) < 0.02, (scope, float(np.median(d)))

    ply = tmp_path / "map.ply"
    save_ply(ply, kvo.map_points, kvo.map_intensity)
    txt = ply.read_text().splitlines()
    assert txt[0] == "ply" and "end_header" in txt
    n_hdr = int([l for l in txt if l.startswith("element vertex")][0].split()[-1])
    assert n_hdr == len(kvo.map_points)
    body = txt[txt.index("end_header") + 1:]
    assert len(body) == n_hdr and len(body[0].split()) == 6


def test_incremental_pose_graph_matches_batch_finalize(loop_sequence):
    """VERDICT r3 item 4: --pg-incremental N re-solves the graph every N
    promotions and rebases keyframe poses; the final batch finalize must
    land on (essentially) the batch-only trajectory — the incremental
    solves only move the graph INIT closer to the optimum."""
    frames, gt_poses = loop_sequence

    batch = _make_kvo()
    list(batch.run(frames))
    t_batch = batch.finalize(iterations=8)

    vo = PhotoconsistencyOdometryAnalytic(CFG)
    vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
    inc = KeyframeVisualOdometry(
        vo, kf_translation=0.08, kf_rotation=0.1, loop_radius=0.15,
        loop_min_gap=2, loop_weight=50.0, pg_incremental=2,
    )
    list(inc.run(frames))
    assert inc.incremental_solves >= 1
    t_inc = inc.finalize(iterations=8)

    assert len(t_inc) == len(t_batch)
    assert len(inc.loop_closures) >= 1
    for a, b in zip(t_inc, t_batch):
        np.testing.assert_allclose(a.pose[:3, 3], b.pose[:3, 3], atol=2e-3)


@pytest.mark.parametrize("chunk", [4])
def test_run_chunked_levelmajor_matches_run(loop_sequence, chunk):
    """Batched (level-major) keyframe tracking — shared keyframe products,
    every frame initialized at the last solved state — must reproduce the
    per-frame path's promotions, edges, and closures exactly, and its
    poses within solver tolerance — the warm-start chain it replaces was an
    initialization aid, not a semantic requirement (all frames of a chunk
    track against the SAME keyframe; with enough iterations both init
    schemes converge to the same optimum)."""
    frames, _ = loop_sequence
    ref = _make_kvo()
    tracked_ref = list(ref.run(frames))
    kvo = _make_kvo()
    tracked = list(kvo.run_chunked(frames, chunk=chunk))

    assert len(tracked) == len(tracked_ref)
    assert [k.frame_index for k in kvo.keyframes] == [
        k.frame_index for k in ref.keyframes
    ]
    assert len(kvo.loop_closures) == len(ref.loop_closures)
    assert [(i, j) for i, j, _ in kvo.odometry_edges] == [
        (i, j) for i, j, _ in ref.odometry_edges
    ]
    for a, b in zip(tracked, tracked_ref):
        assert a.frame_index == b.frame_index
        assert a.keyframe_index == b.keyframe_index
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-3)


def test_run_chunked_ceres_levelmajor_matches_run(loop_sequence):
    """The trust-region (ceres) backend driving the keyframe pipeline at
    chunked speed (VERDICT r4 item 6): run_chunked through the batched
    shared-keyframe TR solve must reproduce the per-frame TR path's
    promotions/edges and poses within solver tolerance."""
    from phovo_tpu.models.autodiff import PhotoconsistencyOdometryAutodiff

    cfg = PhovoConfig(
        num_levels=2,
        blur_filter_sizes=(0, 0),
        gradient_scales=(0.0625, 0.0625),
        max_iterations=(10, 12),
        function_tolerances=(1e-9,) * 2,
        gradient_tolerances=(1e-12,) * 2,
        parameter_tolerances=(1e-10,) * 2,
        initial_trust_region_radii=(1e4,) * 2,
        max_trust_region_radii=(1e8,) * 2,
        min_trust_region_radii=(1e-32,) * 2,
        min_relative_decreases=(1e-3,) * 2,
        sampling="bilinear",
    )
    frames, _ = loop_sequence

    def mk():
        vo = PhotoconsistencyOdometryAutodiff(cfg)
        vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
        return KeyframeVisualOdometry(
            vo, kf_translation=0.08, kf_rotation=0.1,
            loop_radius=0.15, loop_min_gap=2, loop_weight=50.0,
        )

    ref = mk()
    tracked_ref = list(ref.run(frames))
    kvo = mk()
    tracked = list(kvo.run_chunked(frames, chunk=4))
    assert len(tracked) == len(tracked_ref)
    assert [k.frame_index for k in kvo.keyframes] == [
        k.frame_index for k in ref.keyframes
    ]
    assert [(i, j) for i, j, _ in kvo.odometry_edges] == [
        (i, j) for i, j, _ in ref.odometry_edges
    ]
    for a, b in zip(tracked, tracked_ref):
        assert a.keyframe_index == b.keyframe_index
        np.testing.assert_allclose(a.pose, b.pose, atol=2e-3)
