"""Command-line entry point: the framework's replacement for the whole
reference ROS stack (launch files + odometry node + eval publishers).

Usage:
    python -m sage_icp_tpu.runtime.cli --synthetic --frames 100
    python -m sage_icp_tpu.runtime.cli --dataset kitti --root /data/KITTI \
        --sequences 0 1 2 --preset kitti --out results/
    python -m sage_icp_tpu.runtime.cli --dataset kitti360 --root ... \
        --drive 2013_05_28_drive_0000_sync --poses-root ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="sage_icp_tpu odometry runner")
    ap.add_argument("--dataset",
                    choices=["kitti", "kitti360", "kitti_raw", "synthetic"],
                    default="synthetic")
    ap.add_argument("--synthetic", action="store_true",
                    help="shorthand for --dataset synthetic")
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--poses-root", type=str, default=None)
    ap.add_argument("--sequences", type=int, nargs="*", default=[0])
    ap.add_argument("--drive", type=str, default=None)
    ap.add_argument("--date", type=str, default=None,
                    help="raw-KITTI date dir, e.g. 2011_09_26")
    ap.add_argument("--preset", type=str, default="kitti")
    ap.add_argument("--world", choices=["city", "corridor"], default="city",
                    help="synthetic world: 'city' (Manhattan grid, "
                    "structure in all directions) or 'corridor' (single "
                    "road — forward-degenerate for ICP odometry at longer "
                    "runs; kept for experiments)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", type=str, default="results")
    ap.add_argument("--keyframes", action="store_true")
    ap.add_argument("--chunk", type=int, default=0,
                    help="offline-throughput mode: register frames in "
                    "device-side lax.scan chunks of this size")
    ap.add_argument("--no-labels", action="store_true")
    ap.add_argument("--labels-dir", type=str, default=None,
                    help="directory of per-scan .label/.npy semantic "
                    "labels from ANY segmentation model, paired with "
                    "scans by sorted order — the offline analog of the "
                    "reference's /sem_points topic (README.md:30-31, "
                    "sem_odom.launch.py). Overrides dataset GT labels; "
                    "enables semantic mode for kitti360/kitti_raw which "
                    "otherwise run label-0")
    ap.add_argument("--deskew", action="store_true",
                    help="constant-velocity motion compensation; per-point "
                    "timestamps come from the dataset or the azimuth-phase "
                    "fallback (reference pipeline/sageICP.cpp:38-51)")
    ap.add_argument("--image-dir", type=str, default=None,
                    help="camera image directory: write scan-overlay PNGs "
                    "every --image-every frames (reference "
                    "eval/kittiraw_image_pub.py)")
    ap.add_argument("--image-every", type=int, default=50)
    ap.add_argument("--timed-icp", action="store_true",
                    help="clock the ICP solve as its own device dispatch "
                    "per frame so time.txt's t_icp is a real measurement "
                    "(the reference's std::chrono span, sageICP.cpp:79-88)"
                    "; costs one extra solve per frame and forces "
                    "per-frame mode")
    ap.add_argument("--jitter", type=float, default=0.1,
                    help="synthetic-trajectory motion jitter (m/frame "
                    "surge scale; 0 = perfectly constant velocity, which "
                    "STARVES the reference's adaptive threshold — see "
                    "docs/ARCHITECTURE.md round-4 finding)")
    ap.add_argument("--platform", type=str, default=None,
                    help="force a JAX platform (cpu, gpu); the default is "
                    "JAX's own choice")
    args = ap.parse_args(argv)
    if args.synthetic:
        args.dataset = "synthetic"
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from sage_icp_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from sage_icp_tpu.runtime.runner import make_odometry, run_sequence
    from sage_icp_tpu.runtime.keyframes import KeyframeExtractor

    odom = make_odometry(args.preset, deskew=args.deskew)
    all_metrics = {}
    label_dir = None
    if args.labels_dir:
        from sage_icp_tpu.datasets.labels import LabelDirectory

        label_dir = LabelDirectory(args.labels_dir)

    def with_labels(scans):
        return label_dir.wrap(scans) if label_dir is not None else scans

    overlay = None
    if args.image_dir:
        from sage_icp_tpu.runtime.overlay import OverlayWriter

        overlay = OverlayWriter(
            args.image_dir, os.path.join(args.out, "overlays"),
            every=args.image_every,
        )

    if args.dataset == "synthetic":
        from sage_icp_tpu.utils import synthetic

        n = args.frames or 100
        if args.world == "city":
            pts, labs = synthetic.build_city_world(
                seed=1, size=max(420.0, n * 1.2 + 220.0)
            )
        else:
            pts, labs = synthetic.build_world(
                seed=1, length=max(120.0, n * 1.2)
            )
        gt = synthetic.make_trajectory(n, step=1.0, jitter=args.jitter)
        rng = np.random.default_rng(0)
        scans = (
            synthetic.render_scan(pts, labs, gt[i], rng, n_target=30000)
            for i in range(n)
        )
        kf = KeyframeExtractor() if args.keyframes else None
        res = run_sequence(odom, scans, gt_poses=gt, max_frames=n,
                           keyframes=kf, progress=True, seq_name="synthetic",
                           chunk=args.chunk, timed_icp=args.timed_icp)
        res.save(os.path.join(args.out, "synthetic"))
        all_metrics["synthetic"] = res.metrics()

    elif args.dataset == "kitti":
        from sage_icp_tpu.datasets.kitti import KittiOdometrySequence

        for seq in args.sequences:
            ds = KittiOdometrySequence(
                args.root, seq, with_labels=not args.no_labels
            )
            kf = KeyframeExtractor() if args.keyframes else None
            if overlay is not None:
                overlay.set_calib(ds.calib)
            res = run_sequence(
                odom, with_labels(iter(ds)), gt_poses=ds.gt_poses,
                max_frames=args.frames,
                keyframes=kf, progress=True, seq_name=ds.seq,
                chunk=args.chunk, overlay=overlay, timed_icp=args.timed_icp,
            )
            res.save(os.path.join(args.out, f"seq{ds.seq}"), ds.timestamps)
            all_metrics[ds.seq] = res.metrics()

    elif args.dataset == "kitti360":
        from sage_icp_tpu.datasets.kitti360 import Kitti360Sequence

        ds = Kitti360Sequence(args.root, args.drive, args.poses_root)
        gt = None
        if ds.poses is not None:
            gt = [ds.gt_pose(i) for i in range(len(ds))]
            gt = [g for g in gt if g is not None]
        res = run_sequence(
            odom,
            with_labels(ds.read_scan(i) for i in range(len(ds))),
            gt_poses=np.stack(gt) if gt else None,
            max_frames=args.frames,
            progress=True,
            seq_name=args.drive,
            chunk=args.chunk, timed_icp=args.timed_icp,
            overlay=overlay,
        )
        res.save(os.path.join(args.out, args.drive))
        all_metrics[args.drive] = res.metrics()

    elif args.dataset == "kitti_raw":
        from sage_icp_tpu.datasets.kitti_raw import (
            KittiRawSequence, discover_drives,
        )

        drives = (
            [(args.date, args.drive)]
            if args.date and args.drive
            else discover_drives(args.root)
        )
        for date, drive in drives:
            ds = KittiRawSequence(args.root, date, drive)
            res = run_sequence(
                odom, with_labels(iter(ds)), gt_poses=ds.gt_poses,
                max_frames=args.frames,
                progress=True, seq_name=f"{date}_{drive}",
                chunk=args.chunk, overlay=overlay, timed_icp=args.timed_icp,
            )
            res.save(os.path.join(args.out, f"{date}_{drive}"))
            all_metrics[f"{date}_{drive}"] = res.metrics()

    if label_dir is not None and label_dir.mismatched_frames:
        print(f"WARNING: {label_dir.mismatched_frames} frames had "
              "label-length mismatches (padded with label 0) — is the "
              "labels directory from this sequence?")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(json.dumps(all_metrics, indent=2))


if __name__ == "__main__":
    main()
