"""Video watermark pipelines — streaming per-frame DCT–SVD on the GPU.

Counterpart of ``dctsvd_tpu/models/video.py``, with the same capabilities
(the reference's three video modules; SURVEY.md §2.3):

  - grayscale video embed/extract (`embed_watermark_video`,
    `extract_watermark_video`; ref: video_dct_svd.pyc l.57-241)
  - blind statistical detect (`detect_watermark_video`; ref: l.244-315)
  - text watermarks (`embed_text_watermark_video`,
    `extract_text_watermark_video`; ref: l.318-513)
  - per-BGR-channel color variants (ref: color_video_dct_svd.pyc l.58-330)
  - audio-preserving variants via the ffmpeg contract
    (ref: color_video_dct_svd_with_audio.pyc l.58-179)

Two schemes, recorded in ``VideoMeta.scheme``:

  - ``'full'`` (the default, reference parity): every ``frame_interval``-th
    frame's whole-plane DCT goes through ``ops/svd.py::svd_full`` (a
    cuSOLVER library call on the GPU), S' = S + α·Sw over the full
    spectrum (video applies no kfrac truncation, ref: l.130-140), and the
    plane is rebuilt in full f32.
  - ``'blocked'``: the 8×8 scheme's hand-written kernels — K2 embeds u8
    gray planes or channels-last color frames, K1 measures the spectrum at
    the meta's replayed schedule on extraction, and K4 factors the
    watermark's natural-order blocks once (no permutation: the video path
    has no password).

Host structure as in the JAX package: decode on a reader thread, marked
frames batched into chunks of ``chunk`` for one device dispatch each on a
single worker thread (results resolve first in, first out), an ordered
buffer written back through an encoder thread, and segment rolls that
depend only on the frame index, so a resumed run is byte-identical to an
uninterrupted one. Marked frames and each chunk's ``s_orig`` come back to
the host per chunk. Reference quirks kept: the gray pipeline re-encodes
watermarked frames as GRAY2BGR (ref: l.148-151), and mp4v is lossy, so
extraction averages over every marked frame.

Entry points take ``device`` (default ``'cuda'``); the CPU runs only when
the caller passes ``device='cpu'``, and then the kernels' plain twins run.
Device errors are never retried and never become return values.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dctsvd_tpu_torch.io import meta as metaio
from dctsvd_tpu_torch.io import video_io
from dctsvd_tpu_torch.models import blocked as m_blocked
from dctsvd_tpu_torch.models.enhance import _DEVICE_ERRORS
from dctsvd_tpu_torch.models.image import _alpha, _compose
from dctsvd_tpu_torch.models.text import create_text_watermark
from dctsvd_tpu_torch.ops import dct, resize, svd
from dctsvd_tpu_torch.utils.config import (ALPHA_VIDEO_DEFAULT,
                                           FRAME_INTERVAL_DEFAULT,
                                           K_FRAC_DEFAULT)

# cv2's gray conversions at the host boundary keep parity with the
# reference's BGR2GRAY path; import guarded like the io modules.
try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

DEFAULT_DEVICE = "cuda"

#: The ordered buffer's cap in decoded frames (DCTSVD_VIDEO_MAX_BUFFERED).
MAX_BUFFERED_DEFAULT = 32


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def _wm_svd(wm_gray: torch.Tensor):
    """One-time watermark factorization: svd(dct2(wm)) (ref: l.84-101)."""
    return svd.svd_full(dct.dct2(wm_gray.to(torch.float32)))


def _embed_frame_gray(gray: torch.Tensor, sw: torch.Tensor, alpha):
    """[..., H, W] u8 gray frame(s): S' = S + α·Sw, rebuild, clip and
    truncate to u8. Returns (marked u8, original S). No kfrac truncation
    (ref: l.130-140)."""
    u, s, vt = svd.svd_full(dct.dct2(gray.to(torch.float32)))
    s_marked = s + _alpha(alpha, gray.device) * sw
    marked = dct.idct2(_compose(u, s_marked, vt))
    return marked.clamp(0, 255).to(torch.uint8), s


# [..., 3, H, W] channel-first color frames: the same grayscale watermark
# SVs embed into every channel (ref: color_video_dct_svd.pyc l.58-162),
# which is _embed_frame_gray's broadcast over the leading axes.
_embed_frame_color = _embed_frame_gray


def _frame_singular_values(gray: torch.Tensor) -> torch.Tensor:
    """S of each frame's whole-plane DCT, from the full SVD call (never
    ``svdvals``: S − S_orig must cancel exactly on an unmarked frame)."""
    return svd.svd_full(dct.dct2(gray.to(torch.float32)), compute_uv=False)


# --- blocked scheme: the 8×8 kernels (K4 once, K2 per chunk on embed, K1
# per chunk on extract), kfrac-truncated like the blocked image scheme ---

def _wm_svd_blocked(wm_gray: torch.Tensor):
    """One-time per-8×8-block watermark factorization (K4, 5 sweeps), in
    natural block order: the video path has no password layer, so no
    permutation."""
    padded, _, _ = m_blocked._pad_to_blocks(wm_gray.to(torch.float32))
    return svd.jacobi_svd(dct.dct2_plane_blocks(padded), compute_uv=True)


def _embed_frame_gray_blocked(gray: torch.Tensor, sw: torch.Tensor, alpha,
                              kfrac: float = K_FRAC_DEFAULT):
    """[..., H, W] u8 gray frame(s) through K2 with u8 output. Returns
    (marked u8, per-block original S [..., N, 8])."""
    return m_blocked._embed_planes(gray, sw, alpha, kfrac, out_u8=True)


def _embed_frames_color_blocked(frames: torch.Tensor, sw: torch.Tensor,
                                alpha, kfrac: float = K_FRAC_DEFAULT):
    """[..., H, W, 3] decode-layout u8 frames through K2's channels-last
    path (no moveaxis on the host or the device). Returns (marked u8
    [..., H, W, 3], per-block original S [..., 3, N, 8])."""
    return m_blocked._embed_frames(frames, sw, alpha, kfrac)


def _recover_wm_blocked(planes: torch.Tensor, s_orig: torch.Tensor,
                        uw: torch.Tensor, vwt: torch.Tensor, alpha,
                        kfrac: float, h: int, w: int,
                        sw: Optional[torch.Tensor] = None,
                        sweeps=None, channels_last: bool = False):
    """Blocked analog of _recover_wm: per-block ŝw = (S − S_orig)/α (S from
    K1 at the replayed schedule ``sweeps``), shrunk toward the stored Sw
    (the extract tail's front, m_blocked._tail_front: K5f on the card),
    the k embedded components zero-padded to 8, rank-restored through the
    watermark's block bases and inverse block-DCT'd. ``channels_last``:
    planes is [..., H, W, C] decode layout; the estimate still lands
    channel-first [..., C, H, W]."""
    s_now = (m_blocked._frames_spectrum(planes, sweeps) if channels_last
             else m_blocked._plane_spectrum(planes, sweeps))
    k = m_blocked.k_of_block(kfrac)
    # natural block order (no permutation in the video path); the erasure
    # flags are unused: video consumes the estimate
    ident = torch.arange(s_now.shape[-2], device=s_now.device)
    x = m_blocked._tail_front(s_now, s_orig, ident, alpha, k, sw)
    sw_hat = torch.nn.functional.pad(x[..., :k], (0, s_now.shape[-1] - k))
    blocks = _compose(uw, sw_hat, vwt)
    hp, wp = h + (-h) % 8, w + (-w) % 8
    return dct.idct2_blocks_to_plane(blocks, hp, wp)[..., :h, :w]


def _recover_wm(s_now: torch.Tensor, s_orig: torch.Tensor, uw: torch.Tensor,
                vtw: torch.Tensor, alpha) -> torch.Tensor:
    """Ŝw = (S − S_orig)/α; wm_est = idct2((Uw·Ŝw)·Vtw)
    (ref: l.206-229)."""
    sw_est = (s_now - s_orig) / _alpha(alpha, s_now.device)
    return dct.idct2(_compose(uw, sw_est, vtw))


def _frame_stats(gray: torch.Tensor):
    """Per-frame singular-value statistics for blind video detection
    (ref: l.244-315): mean, population std, max, entropy
    −Σ s·log(s + 1e-10)."""
    s = _frame_singular_values(gray)
    return (s.mean(dim=-1), s.std(dim=-1, correction=0), s.amax(dim=-1),
            -(s * torch.log(s + 1e-10)).sum(dim=-1))


# ---------------------------------------------------------------------------
# Host pipelines
# ---------------------------------------------------------------------------

def _prepare_wm_plane(wm_path: Optional[str], text: Optional[str],
                      font_size: int, w: int, h: int,
                      device=DEFAULT_DEVICE) -> np.ndarray:
    if text is not None:
        return create_text_watermark(text, (w, h), font_size)
    if cv2 is None:
        raise RuntimeError("cv2 required")
    wm = cv2.imread(wm_path, cv2.IMREAD_GRAYSCALE)
    if wm is None:
        raise ValueError(f"Cannot open watermark: {wm_path}")
    return resize.resize_area_u8(torch.as_tensor(wm, device=device), h, w,
                                 channels_last=False).cpu().numpy()


def _max_buffered() -> int:
    """DCTSVD_VIDEO_MAX_BUFFERED as a positive int; anything else falls
    back to the default with a RuntimeWarning."""
    raw = os.environ.get("DCTSVD_VIDEO_MAX_BUFFERED")
    if raw is None:
        return MAX_BUFFERED_DEFAULT
    try:
        value = int(raw)
    except ValueError:
        value = 0
    if value < 1:
        warnings.warn(f"DCTSVD_VIDEO_MAX_BUFFERED={raw!r} is not a positive "
                      f"integer; using {MAX_BUFFERED_DEFAULT}",
                      RuntimeWarning, stacklevel=2)
        return MAX_BUFFERED_DEFAULT
    return value


def _embed_video_impl(host_path: str, out_path: str, meta_path: str,
                      wm_plane: np.ndarray, alpha: float,
                      frame_interval: int, color: bool,
                      progress_every: int = 100,
                      progress: Optional[Callable[[int, int], None]] = None,
                      temp_suffix: str = "", retries: int = 2,
                      checkpoint_every: int = 64, chunk: int = 4,
                      scheme: str = "full",
                      kfrac: Optional[float] = None,
                      resume: bool = False, segment_frames: int = 240,
                      device=DEFAULT_DEVICE):
    """Shared embed loop. Writes to out_path+temp_suffix (the with-audio
    variants remux afterwards). meta_path is normalized up front (np.savez
    appends '.npz' itself) so checkpoints, the resume loader and the
    returned path all agree.

    Marked frames batch into device dispatches of ``chunk``: frames buffer
    in arrival order, each full chunk runs one batched embed, and the
    buffer flushes to the writer strictly in order — device work overlaps
    the host's decode of the next window (decode runs on a reader thread,
    video_io.iter_frames_threaded). Partial final chunks pad by repetition
    and drop the padding on write-back.

    ``scheme='full'`` is the reference-parity whole-frame SVD
    (ref: video_dct_svd.pyc l.121-160); ``scheme='blocked'`` routes frames
    through the 8×8 kernels (kfrac-truncated per block) and tags the meta
    so extraction dispatches on ``VideoMeta.scheme``.

    Failure handling (SURVEY.md §5): a dispatch retries up to ``retries``
    times on OSError and TimeoutError only; a device error (out of
    memory, a failed launch) propagates on its first occurrence. The
    meta checkpoints to ``meta_path`` every ``checkpoint_every`` marked
    frames, always with an ``s_orig`` row for every frame index it
    records. With ``resume=True`` the output is written as finalized
    segments of ``segment_frames`` frames (SegmentedVideoWriter) and the
    checkpoint records how many frames are durably on disk — a rerun with
    ``resume=True`` skips them, seeks the reader forward, and continues
    from the last finalized segment; the final output is the segment
    concatenation, byte-identical to an uninterrupted segmented run.
    """
    import collections
    from concurrent.futures import ThreadPoolExecutor
    import threading

    from dctsvd_tpu_torch.utils.profiling import Throughput, logger

    dev = torch.device(device)
    wm_d = torch.as_tensor(np.array(wm_plane), device=dev)
    if scheme == "blocked":
        kfrac = K_FRAC_DEFAULT if kfrac is None else kfrac
        uw_d, sw_d, vtw_d = _wm_svd_blocked(wm_d)
    elif scheme == "full":
        kfrac = 1.0                       # ref video embeds the full spectrum
        uw_d, sw_d, vtw_d = _wm_svd(wm_d)
    else:
        raise ValueError(f"unknown scheme: {scheme!r}")
    alpha_d = _alpha(alpha, dev)
    uw_np, sw_np, vtw_np = (t.cpu().numpy() for t in (uw_d, sw_d, vtw_d))

    write_path = out_path + temp_suffix
    meta_path = metaio._npz_path(meta_path)
    host_sig = _host_signature(host_path)
    frame_indices = []
    s_list = []
    start_frame = 0
    start_segment = 0
    if resume:
        prev = _load_resume_state(meta_path, write_path, scheme, alpha,
                                  frame_interval, color, sw_np,
                                  kfrac, host_sig)
        if prev is not None:
            start_frame, start_segment, frame_indices, s_list = prev
            logger.info("resuming video embed at frame %d (segment %d, "
                        "%d marked frames already recorded)", start_frame,
                        start_segment, len(frame_indices))
    tp = Throughput(name="video-embed frames", log_every=0)

    sched_full, sched_xp = (m_blocked.embed_schedule_used()
                            if scheme == "blocked" else (0, 0))

    def _checkpoint(frames_done: int = -1, segments_done: int = 0):
        meta = metaio.VideoMeta(
            frame_indices=np.asarray(frame_indices, np.int64),
            s_orig=np.stack(s_list) if s_list else
            np.zeros((0, 0), np.float32),
            uw=uw_np, sw=sw_np, vtw=vtw_np,
            alpha=alpha, frame_interval=frame_interval,
            watermark_shape=wm_plane.shape, is_color=color,
            scheme=scheme, kfrac=kfrac,
            frames_done=frames_done, segments_done=segments_done,
            sweeps=sched_full, sweeps_xpairs=sched_xp,
            host_sig=host_sig)
        metaio.save_video_meta(meta_path, meta)
        return meta

    # blocked color rides the channels-last path: frames stay [H, W, 3]
    # u8 end to end (no per-frame host moveaxis copies)
    hwc = color and scheme == "blocked"
    if scheme == "blocked":
        def _embed_fn(planes):
            if color:
                return _embed_frames_color_blocked(planes, sw_d, alpha_d,
                                                   kfrac=kfrac)
            return _embed_frame_gray_blocked(planes, sw_d, alpha_d,
                                             kfrac=kfrac)
    else:
        def _embed_fn(planes):
            fn = _embed_frame_color if color else _embed_frame_gray
            return fn(planes, sw_d, alpha_d)

    def _dispatch_batch(planes: np.ndarray):
        """planes: [K, H, W] gray, [K, 3, H, W] color (full scheme), or
        [K, H, W, 3] decode-layout u8 (blocked color). One device round
        trip for the whole chunk; the marked frames and s_orig come back
        to the host. Only OSError and TimeoutError retry; a device error
        or a programming error surfaces at once. Once a chunk has failed,
        every later chunk raises here without launching anything: a device
        that just ran out of memory gets no further work."""
        if failed.is_set():
            raise RuntimeError("an earlier chunk's dispatch failed")
        transient = (OSError, TimeoutError)
        last_err = None
        try:
            for _ in range(retries + 1):
                try:
                    marked, s_orig = _embed_fn(
                        torch.from_numpy(planes).to(dev))
                    return (np.ascontiguousarray(marked.cpu().numpy()),
                            s_orig.cpu().numpy())
                except transient as e:
                    last_err = e
                    logger.warning("chunk dispatch failed (%s), retrying",
                                   e)
            raise last_err
        except BaseException:
            failed.set()
            raise

    # ordered buffer: ('pass', frame) | ('marked', slot); slots fill at drain
    buf = []
    pending = []           # (slot_id, frame_idx, plane)
    results = {}
    durable = {"frames": start_frame, "segments": start_segment,
               "since_roll": 0, "ckpt_marked": len(frame_indices)}

    # Device dispatches run on a single worker thread, overlapping the
    # main thread's encode and the reader thread's decode; one worker
    # keeps dispatch order = submission order, so results resolve FIFO.
    pool = ThreadPoolExecutor(max_workers=1)
    failed = threading.Event()            # set by the first failed dispatch
    inflight = collections.deque()        # (future, [(slot, frame_idx)])

    def _submit():
        if not pending:
            return
        k = len(pending)
        planes = np.stack([p for _, _, p in pending] +
                          [pending[-1][2]] * (chunk - k))
        fut = pool.submit(_dispatch_batch, planes)
        inflight.append((fut, [(slot, fidx) for slot, fidx, _ in pending]))
        pending.clear()

    def _drain_one():
        fut, slots = inflight.popleft()
        marked, s_orig = fut.result()
        s_list.extend(s_orig[:len(slots)])
        for j, (slot, fidx) in enumerate(slots):
            results[slot] = marked[j]
            frame_indices.append(fidx)
            tp.add()

    def _write_one(writer, kind, payload):
        if kind == "pass":
            writer.write(payload)
        else:
            m = results.pop(payload)
            if hwc:
                writer.write(m)           # already decode-layout u8
            elif color:
                writer.write(np.ascontiguousarray(np.moveaxis(m, 0, -1)))
            else:
                writer.write(cv2.cvtColor(m, cv2.COLOR_GRAY2BGR))
        durable["since_roll"] += 1
        _maybe_roll(writer)

    def _pump(writer, wait: bool = False):
        """Write the longest prefix of the ordered buffer whose marked
        results are available; with wait=True, block until everything
        buffered so far is written. Segment rolls happen per frame, so
        segment boundaries depend only on the frame index — never on
        flush/drain timing — which keeps resumed runs byte-identical.

        Ready frames are written BEFORE the next future resolves: a failed
        dispatch must not abort frames that already computed — they roll
        into finalized segments the failed run can resume from."""
        while True:
            while buf:
                kind, payload = buf[0]
                if kind == "marked" and payload not in results:
                    break
                buf.pop(0)
                _write_one(writer, kind, payload)
            if (len(frame_indices) - durable["ckpt_marked"]
                    >= checkpoint_every):
                durable["ckpt_marked"] = len(frame_indices)
                _checkpoint(durable["frames"], durable["segments"])
            if wait and not inflight and pending and buf:
                # The head of buf is a marked slot whose chunk is still
                # filling and nothing is in flight: force the partial chunk
                # out, otherwise passthrough frames would keep accumulating
                # up to frame_interval x chunk frames (the buffer cap only
                # bounds RAM if hitting it guarantees progress).
                _submit()
            if not inflight or not (wait or inflight[0][0].done()):
                return
            _drain_one()

    def _maybe_roll(enc) -> bool:
        """Finalize the open segment once it reaches segment_frames.
        ``sync_roll`` drains the async-encode queue first, so every frame
        counted is durably encoded before the checkpoint records it."""
        if not (resume and durable["since_roll"] >= segment_frames):
            return False
        frames_done = enc.sync_roll()
        segs = raw_writer["w"].segment
        durable.update(frames=frames_done, segments=segs, since_roll=0)
        _checkpoint(frames_done, segs)
        return True

    raw_writer = {}

    slot_counter = 0
    try:
        with video_io.VideoReader(host_path) as reader:
            if resume:
                writer_cm = video_io.SegmentedVideoWriter(
                    write_path, reader.fps, reader.width, reader.height,
                    start_segment=start_segment, frames_done=start_frame)
            else:
                writer_cm = video_io.VideoWriter(write_path, reader.fps,
                                                 reader.width, reader.height)
            with writer_cm as writer:
                raw_writer["w"] = writer
                # encode runs on its own thread; FIFO order keeps segment
                # boundaries byte-identical to the synchronous writer
                enc = video_io.AsyncEncoder(writer)
                # Passthrough frames drain straight to the writer whenever
                # no marked frame is awaiting its device result ahead of
                # them; otherwise the buffer cap makes _pump(wait=True)
                # guarantee progress — dispatching the partial chunk if
                # that is what blocks the head — so host RAM between
                # flushes is bounded by max_buffered decoded frames.
                max_buffered = _max_buffered()
                try:
                    for idx, frame in video_io.iter_frames_threaded(
                            reader, start_frame=start_frame):
                        if idx % frame_interval == 0:
                            if hwc:
                                plane = frame
                            elif color:
                                plane = np.moveaxis(frame, -1, 0)
                            else:
                                plane = cv2.cvtColor(frame,
                                                     cv2.COLOR_BGR2GRAY)
                            buf.append(("marked", slot_counter))
                            pending.append((slot_counter, idx, plane))
                            slot_counter += 1
                            if len(pending) >= chunk:
                                _submit()      # async: don't block writes
                                # at frame_interval=1 every frame lands
                                # here: without the wait the buffer and
                                # the executor queue grow without bound
                                _pump(enc, wait=len(buf) >= max_buffered)
                        elif pending or buf:
                            buf.append(("pass", frame))
                            _pump(enc, wait=len(buf) >= max_buffered)
                        else:
                            _write_one(enc, "pass", frame)
                        if progress and idx % progress_every == 0:
                            progress(idx, reader.total_frames)
                    _submit()
                    _pump(enc, wait=True)
                except BaseException:
                    # drain the encode queue BEFORE the writer closes so
                    # already-computed frames land in finalized segments a
                    # rerun can resume from — but never mask the in-flight
                    # exception with an encoder one
                    try:
                        enc.close()
                    except BaseException:
                        pass
                    raise
                else:
                    enc.close()
                if resume:
                    writer.finalize()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    meta = _checkpoint()
    return write_path, meta_path, meta


def _host_signature(host_path: str) -> str:
    """Cheap host-file identity for resume binding: basename, byte size and
    mtime. Not content-hashed (a 4K clip can be GBs), but enough to catch
    the realistic accidents — resuming against a different file at the same
    path or the same name re-rendered."""
    try:
        st = os.stat(host_path)
        return (f"{os.path.basename(host_path)}:{st.st_size}"
                f":{int(st.st_mtime)}")
    except OSError:
        return ""


def _load_resume_state(meta_path: str, write_path: str, scheme: str,
                       alpha: float, frame_interval: int, color: bool,
                       sw_now: np.ndarray, kfrac: float, host_sig: str):
    """Validate a checkpoint meta + finalized segments for resume; returns
    (start_frame, start_segment, frame_indices, s_list) or None (fresh
    start). The checkpoint's durable frame count is trusted only when every
    finalized segment it references still exists, and the checkpointed
    watermark singular values must match the CURRENT watermark's (``sw_now``)
    — otherwise a rerun with a different watermark would silently splice
    segments carrying the old mark. ``kfrac``, the Jacobi schedule and the
    host signature bind the remaining embed parameters: a rerun with a
    different truncation or schedule, or against a different host file,
    must restart."""
    if not os.path.exists(meta_path):
        return None
    try:
        prev = metaio.load_video_meta(meta_path)
    except Exception:
        return None
    if (prev.frames_done <= 0 or prev.scheme != scheme
            or prev.is_color != color
            or abs(prev.alpha - alpha) > 1e-12
            or abs(prev.kfrac - kfrac) > 1e-12
            or prev.frame_interval != frame_interval):
        return None
    # splicing segments embedded under different schedules would leave the
    # final meta recording only the last run's, breaking extraction's
    # replay for the earlier frames
    sched_now = (m_blocked.embed_schedule_used() if scheme == "blocked"
                 else (0, 0))
    if (prev.sweeps, prev.sweeps_xpairs) != sched_now:
        return None
    # checkpoints without host_sig ("") stay resumable; any recorded
    # signature must match the current host file exactly
    if prev.host_sig and prev.host_sig != host_sig:
        return None
    sw_prev = np.asarray(prev.sw)
    if (sw_prev.shape != sw_now.shape
            or not np.allclose(sw_prev, sw_now, rtol=1e-5, atol=1e-3)):
        return None
    segs = video_io.SegmentedVideoWriter.existing_segments(write_path)
    have = {os.path.basename(s) for s in segs}
    need = {f"{os.path.basename(write_path)}.seg{i:04d}.mp4"
            for i in range(prev.segments_done)}
    if not need.issubset(have):
        return None
    keep = prev.frame_indices < prev.frames_done
    return (int(prev.frames_done), int(prev.segments_done),
            list(prev.frame_indices[keep]),
            [np.asarray(s) for s in prev.s_orig[keep]])


def _tag_text(meta_p: str, meta, text: str, font_size: int) -> None:
    meta.is_text = True
    meta.text = text
    meta.font_size = font_size
    metaio.save_video_meta(meta_p, meta)


def embed_watermark_video(host_path: str, wm_path: str, out_path: str,
                          meta_path: str,
                          alpha: float = ALPHA_VIDEO_DEFAULT,
                          frame_interval: int = FRAME_INTERVAL_DEFAULT,
                          progress: Optional[Callable] = None,
                          scheme: str = "full",
                          resume: bool = False, device=DEFAULT_DEVICE):
    """Grayscale video embed (ref: video_dct_svd.pyc l.57-167).
    ``scheme='blocked'`` uses the 8×8 kernels; ``resume=True`` writes
    checkpointable segments and continues an interrupted run from the
    last finalized segment."""
    info = video_io.get_video_info(host_path)
    wm = _prepare_wm_plane(wm_path, None, 0, info["width"], info["height"],
                           device=device)
    _, meta_p, _ = _embed_video_impl(host_path, out_path, meta_path, wm,
                                     alpha, frame_interval, color=False,
                                     progress=progress, scheme=scheme,
                                     resume=resume, device=device)
    return out_path, meta_p


def embed_text_watermark_video(host_path: str, text: str, out_path: str,
                               meta_path: str,
                               alpha: float = ALPHA_VIDEO_DEFAULT,
                               font_size: int = 40,
                               frame_interval: int = FRAME_INTERVAL_DEFAULT,
                               progress: Optional[Callable] = None,
                               scheme: str = "full", resume: bool = False,
                               device=DEFAULT_DEVICE):
    """Text watermark variant (ref: l.318-430); text round-trips through
    the meta, not the pixels (ref: l.433-513)."""
    info = video_io.get_video_info(host_path)
    wm = create_text_watermark(text, (info["width"], info["height"]),
                               font_size)
    _, meta_p, meta = _embed_video_impl(host_path, out_path, meta_path, wm,
                                        alpha, frame_interval, color=False,
                                        progress=progress, scheme=scheme,
                                        resume=resume, device=device)
    _tag_text(meta_p, meta, text, font_size)
    return out_path, meta_p


def embed_watermark_video_color(host_path: str, wm_path: str, out_path: str,
                                meta_path: str,
                                alpha: float = ALPHA_VIDEO_DEFAULT,
                                frame_interval: int = FRAME_INTERVAL_DEFAULT,
                                progress: Optional[Callable] = None,
                                scheme: str = "full", resume: bool = False,
                                device=DEFAULT_DEVICE):
    """Color (per-BGR-channel) embed (ref: color_video_dct_svd.pyc
    l.58-162)."""
    info = video_io.get_video_info(host_path)
    wm = _prepare_wm_plane(wm_path, None, 0, info["width"], info["height"],
                           device=device)
    _, meta_p, _ = _embed_video_impl(host_path, out_path, meta_path, wm,
                                     alpha, frame_interval, color=True,
                                     progress=progress, scheme=scheme,
                                     resume=resume, device=device)
    return out_path, meta_p


def embed_text_watermark_video_color(host_path: str, text: str,
                                     out_path: str, meta_path: str,
                                     alpha: float = ALPHA_VIDEO_DEFAULT,
                                     font_size: int = 40,
                                     frame_interval: int =
                                     FRAME_INTERVAL_DEFAULT,
                                     progress: Optional[Callable] = None,
                                     scheme: str = "full",
                                     resume: bool = False,
                                     device=DEFAULT_DEVICE):
    """(ref: color_video_dct_svd.pyc l.165-269)."""
    info = video_io.get_video_info(host_path)
    wm = create_text_watermark(text, (info["width"], info["height"]),
                               font_size)
    _, meta_p, meta = _embed_video_impl(host_path, out_path, meta_path, wm,
                                        alpha, frame_interval, color=True,
                                        progress=progress, scheme=scheme,
                                        resume=resume, device=device)
    _tag_text(meta_p, meta, text, font_size)
    return out_path, meta_p


def embed_watermark_video_color_with_audio(host_path: str, wm_path: str,
                                           out_path: str, meta_path: str,
                                           alpha: float =
                                           ALPHA_VIDEO_DEFAULT,
                                           frame_interval: int =
                                           FRAME_INTERVAL_DEFAULT,
                                           scheme: str = "full",
                                           resume: bool = False,
                                           device=DEFAULT_DEVICE):
    """Color embed + ffmpeg audio remux; without ffmpeg (or on any remux
    failure) the silent video is moved into place and ``had_audio`` is
    False, the reference's contract (ref: color_video_dct_svd_with_audio
    .pyc l.58-179)."""
    info = video_io.get_video_info(host_path)
    wm = _prepare_wm_plane(wm_path, None, 0, info["width"], info["height"],
                           device=device)
    temp, meta_p, _ = _embed_video_impl(host_path, out_path, meta_path, wm,
                                        alpha, frame_interval, color=True,
                                        temp_suffix=".temp.mp4",
                                        scheme=scheme, resume=resume,
                                        device=device)
    had_audio = video_io.finalize_with_audio(temp, host_path, out_path,
                                             want_audio=True)
    return out_path, meta_p, had_audio


def embed_text_watermark_video_color_with_audio(host_path: str, text: str,
                                                out_path: str,
                                                meta_path: str,
                                                alpha: float =
                                                ALPHA_VIDEO_DEFAULT,
                                                font_size: int = 40,
                                                frame_interval: int =
                                                FRAME_INTERVAL_DEFAULT,
                                                scheme: str = "full",
                                                resume: bool = False,
                                                device=DEFAULT_DEVICE):
    """(ref: color_video_dct_svd_with_audio.pyc l.182-~300)."""
    info = video_io.get_video_info(host_path)
    wm = create_text_watermark(text, (info["width"], info["height"]),
                               font_size)
    temp, meta_p, meta = _embed_video_impl(host_path, out_path, meta_path,
                                           wm, alpha, frame_interval,
                                           color=True,
                                           temp_suffix=".temp.mp4",
                                           scheme=scheme, resume=resume,
                                           device=device)
    _tag_text(meta_p, meta, text, font_size)
    had_audio = video_io.finalize_with_audio(temp, host_path, out_path,
                                             want_audio=True)
    return out_path, meta_p, had_audio


def extract_watermark_video(video_path: str, meta_path: str,
                            out_path: str, chunk: int = 4,
                            device=DEFAULT_DEVICE) -> str:
    """Average per-frame watermark estimates over all recorded frames
    (ref: video_dct_svd.pyc l.170-241; color: color_video_dct_svd.pyc
    l.272-330 additionally averages the three channels). Marked frames
    batch into device dispatches of ``chunk``; decode (seek+read) runs on
    a producer thread overlapping device work, the cross-frame sum
    accumulates on the device, and only the averaged plane is read back.
    A meta of either package extracts here: the blocked scheme replays
    the meta's own Jacobi schedule."""
    import queue
    import threading

    dev = torch.device(device)
    meta = metaio.load_video_meta(meta_path)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    alpha_d = _alpha(max(meta.alpha, 1e-8), dev)
    uw_d, vtw_d, sw_d = f32(meta.uw), f32(meta.vtw), f32(meta.sw)
    h, w = meta.watermark_shape[:2]
    blocked_scheme = meta.scheme == "blocked"
    hwc_x = blocked_scheme and meta.is_color   # channels-last device path

    acc_d = None
    count = 0
    planes_buf = []
    sorig_buf = []

    def _flush():
        nonlocal acc_d, count
        if not planes_buf:
            return
        k = len(planes_buf)
        pad = chunk - k
        planes = torch.from_numpy(
            np.stack(planes_buf + [planes_buf[-1]] * pad)).to(dev)
        sorig = f32(np.stack(sorig_buf + [sorig_buf[-1]] * pad))
        if blocked_scheme:
            est = _recover_wm_blocked(planes, sorig, uw_d, vtw_d, alpha_d,
                                      meta.kfrac, h, w, sw=sw_d,
                                      sweeps=meta.sched(),
                                      channels_last=hwc_x)
        else:
            s_now = _frame_singular_values(planes)
            est = _recover_wm(s_now, sorig, uw_d, vtw_d, alpha_d)
        if meta.is_color:
            est = est.mean(dim=-3)                   # [K, H, W]
        est_sum = est[:k, :h, :w].sum(dim=0)         # device-resident
        acc_d = est_sum if acc_d is None else acc_d + est_sum
        count += k
        planes_buf.clear()
        sorig_buf.clear()

    # producer: random-access decode on its own thread (it owns the
    # capture; cv2.VideoCapture is not shared across threads)
    q: "queue.Queue" = queue.Queue(maxsize=max(2 * chunk, 8))
    _DONE = object()
    stop = threading.Event()

    def _producer():
        try:
            with video_io.VideoReader(video_path) as reader:
                for i, idx in enumerate(meta.frame_indices):
                    if stop.is_set():
                        return
                    frame = reader.seek_read(int(idx))
                    if frame is None:
                        continue
                    _put((i, frame))
            _put(_DONE)
        except BaseException as e:
            _put(e)

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=_producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            i, frame = item
            if hwc_x:
                planes_buf.append(frame)      # decode layout, no host copy
            elif meta.is_color:
                planes_buf.append(np.moveaxis(frame, -1, 0))
            else:
                planes_buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
            sorig_buf.append(np.asarray(meta.s_orig[i]))
            if len(planes_buf) >= chunk:
                _flush()
        _flush()
    finally:
        # a device error mid-clip must not leave the producer blocked on
        # a full queue
        stop.set()
        t.join()
    if acc_d is None:
        raise ValueError("No recorded frames could be read from the video.")
    wm = np.clip(acc_d.cpu().numpy() / count, 0, 255).astype(np.uint8)
    cv2.imwrite(out_path, wm)
    return out_path


def extract_text_watermark_video(video_path: str, meta_path: str,
                                 out_path: str,
                                 device=DEFAULT_DEVICE) -> Optional[str]:
    """Same math; returns the embedded text recovered from the meta
    (ref: l.433-513 — the text round-trips through metadata)."""
    extract_watermark_video(video_path, meta_path, out_path, device=device)
    return metaio.load_video_meta(meta_path).text


def detect_watermark_video(video_path: str,
                           frame_sample_rate: int = 30,
                           chunk: int = 8, device=DEFAULT_DEVICE) -> Dict:
    """Blind statistical heuristic over sampled frames
    (ref: video_dct_svd.pyc l.244-315). Frames batch on the device in
    chunks — one SVD call per ``chunk`` sampled frames. A host failure (a
    missing or unreadable file) returns ``{"error": str(e)}`` as in the
    reference; a device error propagates."""
    try:
        stats = {"means": [], "stds": [], "maxes": [], "entropies": []}
        sampled = 0
        buf = []

        def flush():
            nonlocal sampled
            if not buf:
                return
            batch = torch.from_numpy(np.stack(buf)).to(device)  # u8
            m, s, mx, e = (v.cpu().numpy() for v in _frame_stats(batch))
            stats["means"].extend(m.tolist())
            stats["stds"].extend(s.tolist())
            stats["maxes"].extend(mx.tolist())
            stats["entropies"].extend(e.tolist())
            sampled += len(buf)
            buf.clear()

        with video_io.VideoReader(video_path) as reader:
            for idx, frame in enumerate(reader):
                if idx % frame_sample_rate == 0:
                    buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
                    if len(buf) >= chunk:
                        flush()
            flush()

        if sampled == 0:
            return {"error": "no frames analyzed"}
        mean_std = float(np.std(stats["means"]))
        std_std = float(np.std(stats["stds"]))
        likelihood = 1.0 / (1.0 + mean_std + std_std)
        return {
            "total_frames_analyzed": sampled,
            "watermark_likelihood": likelihood,
            "frame_statistics": stats,
            "mean_consistency": mean_std,
            "std_consistency": std_std,
        }
    except _DEVICE_ERRORS:
        raise
    except Exception as e:  # ref returns {'error': ...} on failure
        return {"error": str(e)}


get_video_info = video_io.get_video_info
