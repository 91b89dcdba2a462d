"""Online (streaming) visual SLAM session.

Port of the JAX package's ``models/streaming.py``. The batch pipeline
(:func:`~.slam.run_slam_from_images`) ingests the whole sequence up front,
the right shape for datasets and benchmarks, the wrong one for a live
camera. :class:`SlamSession` is the online mode: feed frames one at a time;
every ``SlamConfig.ba_interval`` frames the session runs ONE incremental
step — batched detect+describe on the buffered window, incremental
descriptor tracking (the batch path's matcher and verifier), and the
back end's windowed PnP + triangulation + BA — and returns the provisional
trajectory. ``finalize()`` runs the global final BA (+ optional pose graph)
and returns the definitive result.

The back end is not reimplemented: the session drives
:func:`~.slam.run_slam` through its checkpoint/resume machinery — each step
resumes from the previous step's persisted state (an in-process ``mem://``
store by default), processes exactly the new window (``_stop_after`` skips
the final BA), and persists again. The state arrays grow between resumes
(new frames, new tracks); ids are append-only, so the prefix restore in
``run_slam`` is exact. Track building is the batch path's
(:func:`~.slam.chain_frames`), one window at a time: the session's result is
the batch run's, bit for bit.

Streaming loop-closure association is not implemented (the batch
``loop_stride`` pass remaps track ids globally, which would break the
append-only resume contract); run the batch pipeline for loop-shaped
sequences.
"""

from __future__ import annotations

import uuid

import numpy as np
import torch

from ..config import SiftConfig
from ..core.device import Device
from ..parallel.distributed import detect_and_describe_data_parallel
from ..utils.checkpoint import remove_checkpoint
from .frontend import detect_and_describe_batched
from .slam import (
    SlamConfig,
    SlamResult,
    _target,
    _upload_dtype,
    chain_frames,
    run_slam,
    tracks_to_arrays,
)


class SlamSession:
    """Incremental monocular SLAM over a live frame stream.

    Usage::

        sess = SlamSession(k_mat, sift_cfg, slam_cfg)
        for frame in camera:                 # (H, W) grayscale
            update = sess.add_frame(frame)   # SlamResult every window,
            if update is not None:           # None in between
                use(update.rotations, update.translations)
        result = sess.finalize()             # global BA (+ pose graph)

    ``workdir``: where the back end's rolling state lives between steps
    (an in-process ``mem://`` store by default); a disk directory survives
    the process. The state is ``run_slam``'s checkpoint, and each step after
    the first resumes from it, so the back end state a session of the JAX
    package left in a directory is read here too, npz + JSON or orbax
    alike (an orbax state holds no pose gate steps: they are re-seeded
    from its trajectory, as in JAX).

    ``device``: see ``core/device.py`` (the card, or an error where there
    is none, unless ``device="cpu"``); ``dtype``: the back end's
    (``models/slam.py``). ``blur``: the frontend's (``models/frontend.py``),
    as ``run_slam_from_images`` takes it. ``mesh``: a ``DeviceMesh`` of ``parallel/``; each
    step's frontend, window matching and BA then run over its ranks, as the
    batch run's do (``models/slam.py``), and every rank steps the same
    session on the same frames.
    """

    def __init__(
        self,
        k_mat: np.ndarray,
        sift_cfg: SiftConfig | None = None,
        slam_cfg: SlamConfig | None = None,
        *,
        blur: str = "fused",
        match_ratio: float = 0.9,
        max_tracks: int = 4096,
        reassoc_window: int = 2,
        max_match_px: float | None = None,
        ransac_threshold_px: float = 2.0,
        workdir: str | None = None,
        mesh=None,
        device: Device = None,
        dtype: torch.dtype = torch.float32,
    ):
        self.device = _target(device, mesh)
        self.mesh = mesh
        self.dtype = dtype
        self.k_mat = np.asarray(k_mat)
        self.sift_cfg = sift_cfg or SiftConfig()
        self.slam_cfg = slam_cfg or SlamConfig()
        self.blur = blur
        self.match_ratio = match_ratio
        self.max_tracks = max_tracks
        self.reassoc_window = reassoc_window
        self.max_match_px = max_match_px
        self.ransac_threshold_px = ransac_threshold_px
        self.window = max(1, self.slam_cfg.ba_interval)
        # The default state store is IN-MEMORY (mem://, utils/checkpoint.py):
        # a disk round trip per step is pure overhead in the online step
        # latency. Pass a real directory to survive process death mid-stream.
        self._owns_workdir = workdir is None
        self._workdir = workdir or f"mem://slam_session_{uuid.uuid4().hex}"

        # The first back-end window starts at this frame (run_slam: 1 with a
        # wide bootstrap, else 2); step boundaries must land on the window
        # grid start_f0 + k*win, or each resume would re-phase the back
        # end's windows against the batch pipeline (same tracks, ATE 0.216
        # against 0.03 in the JAX package from phasing alone).
        self._start_f0 = 1 if self.slam_cfg.bootstrap_baseline > 1 else 2
        self._buf: list[np.ndarray] = []
        # The device descriptor buffer holds only the matching horizon (the
        # last reassoc_window+1 processed frames) plus the new window:
        # nothing older is ever matched in streaming mode, and keeping the
        # full history would grow device memory without bound.
        self._desc = None  # (H, S, D) device tensor, frames >= _dev_base
        self._valid = None  # (H, S) device tensor
        self._dev_base = 0  # global frame index of _desc[0]
        self._xs = None  # (F, S) host
        self._ys = None
        self._valid_host = None  # (F, S) host
        self._track_of = None  # (F, S) host, -1 = untracked
        self._next_track = 0
        self._frames_done = 0
        self._started = False
        self._last: SlamResult | None = None

    # -- public API ----------------------------------------------------

    def add_frame(self, image: np.ndarray) -> SlamResult | None:
        """Buffer one frame; step the pipeline when the window fills.

        Returns the provisional :class:`~.slam.SlamResult` after a step,
        else ``None``. Provisional = no final BA / pose graph yet.
        """
        self._buf.append(np.asarray(image))
        total = self._frames_done + len(self._buf)
        if (
            total >= self._start_f0 + self.window
            and (total - self._start_f0) % self.window == 0
        ):
            return self._step()
        return None

    def finalize(self) -> SlamResult:
        """Flush any partial window, run the global final BA, return."""
        if self._buf:
            self._step()
        if self._frames_done < 2:
            raise ValueError("need at least 2 processed frames")
        result = self._run(resume=True)
        if self._owns_workdir:
            # Evict the session's rolling state from the mem:// store —
            # without this every finished session leaks its final pose and
            # observation buffers for the life of the process (a
            # user-provided workdir is the user's to keep).
            remove_checkpoint(self._workdir)
        return result

    @property
    def frames_processed(self) -> int:
        return self._frames_done

    # -- internals -----------------------------------------------------

    def _run(self, resume: bool, stop_after: int | None = None) -> SlamResult:
        pixels, visible = tracks_to_arrays(
            self._track_of, self._xs, self._ys, max(self._next_track, 8)
        )
        return run_slam(
            pixels,
            visible,
            self.k_mat,
            self.slam_cfg,
            mesh=self.mesh,
            checkpoint_dir=self._workdir,
            checkpoint_interval=self.window,
            resume=resume,
            _stop_after=stop_after,
            device=self.device,
            dtype=self.dtype,
        )

    def _step(self) -> SlamResult:
        frames = np.stack(self._buf)
        self._buf.clear()
        self._extend_tracks(frames)
        result = self._run(resume=self._started, stop_after=self._frames_done - 1)
        self._started = True
        self._last = result
        return result

    def _extend_tracks(self, frames: np.ndarray) -> None:
        """Detect+describe the new frames and chain them into tracks
        (:func:`~.slam.chain_frames`, as the batch run chains them)."""
        images = torch.from_numpy(np.ascontiguousarray(frames, _upload_dtype(frames)))
        if self.mesh is None:
            described = detect_and_describe_batched(images.to(self.device), self.sift_cfg,
                                                     self.blur, device=self.device)
        else:
            described = detect_and_describe_data_parallel(images, self.sift_cfg, self.mesh,
                                                          self.blur)
        f0 = self._frames_done  # global index of the first new frame
        valid_new = described.valid.cpu().numpy()
        xs_new = described.abs_x.cpu().numpy()
        ys_new = described.abs_y.cpu().numpy()

        if self._desc is None:
            self._desc, self._valid = described.descriptor, described.valid
            self._xs, self._ys, self._valid_host = xs_new, ys_new, valid_new
            self._track_of = np.full(valid_new.shape, -1, np.int64)
        else:
            self._desc = torch.cat([self._desc, described.descriptor])
            self._valid = torch.cat([self._valid, described.valid])
            self._xs = np.concatenate([self._xs, xs_new])
            self._ys = np.concatenate([self._ys, ys_new])
            self._valid_host = np.concatenate([self._valid_host, valid_new])
            self._track_of = np.concatenate(
                [self._track_of, np.full(valid_new.shape, -1, np.int64)]
            )
        self._next_track = chain_frames(
            self._desc, self._valid, self._dev_base, self._xs, self._ys, self._valid_host,
            self._track_of, self._next_track, f0, self.k_mat, self.match_ratio,
            self.max_tracks, self.ransac_threshold_px, self.reassoc_window, self.max_match_px,
            mesh=self.mesh,
        )
        num_frames = f0 + frames.shape[0]

        # Trim the device buffer to the matching horizon: the next step
        # matches frames >= num_frames - 1 - reassoc_window only.
        h = self.reassoc_window + 1
        n_dev = num_frames - self._dev_base
        if n_dev > h:
            self._desc = self._desc[n_dev - h :]
            self._valid = self._valid[n_dev - h :]
            self._dev_base = num_frames - h

        self._frames_done = num_frames
