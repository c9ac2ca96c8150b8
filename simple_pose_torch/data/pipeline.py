"""Host input pipeline: JPEG decode and tiny matrix math only; the crop,
augmentation warp, target encoding and normalization run on the device.

Port of simple_pose_tpu/data/pipeline.py:44-471 (``PosePipeline`` for
training and eval, ``DetBoxPipeline`` for detector boxes).  Per sample the
host:

  1. decodes the JPEG and pastes it (RGB) into a fixed uint8 canvas at the
     origin -- no interpolation on the host, so the device bilinear crop is
     the single resample, like cv2.warpAffine on the original image (zero
     padding beyond the true image equals BORDER_CONSTANT 0);
  2. draws augmentation parameters (DPG box jitter, scale 0.7-1.3, rotation
     +-40, p=0.5 horizontal flip) from ``default_rng((seed, epoch, ridx))``
     and composes them into two 2x3 affines (crop matrix, output-space
     matrix): the image flip is folded into the matrices via hflip_affine,
     so the host never touches pixels;
  3. transforms joints into heatmap space (affine_transform_batch parity).

A batch is {canvas u8 [B,S,S,3], trans f32 [B,2,3], joints f32 [B,17,3],
trans_inv f32 [B,2,3], img_id i64 [B], valid f32 [B]}, plus area/score f32
[B] for detector boxes; with canvas dedup the canvas is [U,S,S,3] and
``canvas_idx`` i32 [B] picks each crop's canvas.  Batches are built in a
thread pool with a bounded prefetch window; each process takes a stride of
the epoch permutation.

Decoding: ``.jpg``/``.jpeg`` files go through the native loader
(data/native.py: libjpeg, or where it is absent the port's decoder with
libjpeg's arithmetic; one batched ctypes call that releases the
interpreter lock) when the pipeline has one; anything else goes through
:func:`_imread_rgb`: a ``.png`` that utils/viz.read_png reads (8-bit RGB
or grayscale, filter 0: what ``write_png`` writes) decodes with numpy and
zlib alone, and every other file, a PNG that ``read_png`` refuses too,
through cv2, imported when called (an ImportError where it is absent).
``use_native=True`` raises where the loader cannot be built, ``False``
never builds it, and ``None`` takes it where it builds and says once which
decoder it took.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from simple_pose_torch.data import native
from simple_pose_torch.data.coco import JOINT_PAIRS, DetBoxRecord, PoseRecord
from simple_pose_torch.ops import affine as A
from simple_pose_torch.utils.viz import read_png

__all__ = ["PosePipeline", "DetBoxPipeline", "RGB_MEAN"]

# normalization parity quirk: mean subtract only, NO std divide
# (datasets/coco.py:134-136)
RGB_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)


def _imread_rgb(path):
    """An image file as HxWx3 uint8 RGB, the pixels cv2.imread reads
    (grayscale as three equal channels)."""
    if path.lower().endswith(".png"):
        try:
            img = read_png(path)
        except ValueError:  # another kind of PNG: cv2 reads it, or raises
            pass
        else:
            return img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)
    import cv2 as cv

    cv.setNumThreads(0)
    img = cv.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1]  # BGR -> RGB


class _SampleTransform:
    """Geometry for one sample: reproduces RefineSimpleTransform.__call__
    (commons/transforms.py:193-223) with the image flip/warp folded into
    matrices."""

    def __init__(self, input_shape=(192, 256), output_shape=(48, 64),
                 scale=(0.7, 1.3), rot=(-40, 40), rand_crop=True, flip=True):
        self.input_shape = input_shape
        self.output_shape = output_shape
        self.w_h_ratio = input_shape[0] / input_shape[1]
        self.scale = scale
        self.rot = rot
        self.rand_crop = rand_crop
        self.flip = flip

    def __call__(self, rec: PoseRecord, rng: np.random.Generator, augment: bool):
        joints = rec.joints.copy()
        bbox = list(rec.box)
        if augment and self.rand_crop:
            bbox = A.box_jitter(bbox, rec.width, rec.height, rng)
        x1, y1, x2, y2 = bbox
        center, scale = A.box_to_center_scale(x1, y1, x2 - x1, y2 - y1, self.w_h_ratio)
        if augment:
            scale = scale * rng.uniform(self.scale[0], self.scale[1])
            rot = rng.uniform(self.rot[0], self.rot[1])
        else:
            rot = 0.0
        flipped = augment and self.flip and rng.uniform() < 0.5
        if flipped:
            joints = A.flip_joints(joints, rec.width, JOINT_PAIRS)
            center = center.copy()
            center[0] = rec.width - center[0] - 1

        img_trans, _ = A.get_affine_transform(center, scale, rot, self.input_shape)
        out_trans, out_trans_inv = A.get_affine_transform(center, scale, rot, self.output_shape)
        if flipped:
            # fold np.fliplr into the sampling matrices (image stays unflipped)
            img_trans = A.compose_affine(img_trans, A.hflip_affine(rec.width))
        joints_out = A.affine_transform_joints(joints, out_trans)
        return (
            img_trans.astype(np.float32),
            joints_out.astype(np.float32),
            np.asarray(out_trans_inv, dtype=np.float32),
        )


class _Prefetcher:
    """Thread-pool batch producer with a bounded prefetch window.

    Workers may run at most ``prefetch`` batches ahead of the consumer; a
    worker exception is captured and re-raised at the consumer instead of
    hanging it."""

    def __init__(self, make_batch, num_batches, num_threads=8, prefetch=4):
        self._make_batch = make_batch
        self._num = num_batches
        self._threads = max(1, num_threads)
        self._prefetch = max(1, prefetch)

    def __iter__(self):
        indices = queue.Queue()
        for i in range(self._num):
            indices.put(i)
        results = {}
        cond = threading.Condition(threading.Lock())
        window = threading.Semaphore(self._prefetch)
        consumed = threading.Event()

        def worker():
            while True:
                window.acquire()
                if consumed.is_set():
                    return
                try:
                    i = indices.get_nowait()
                except queue.Empty:
                    return
                try:
                    b = self._make_batch(i)
                except BaseException as e:  # propagate to the consumer
                    b = e
                with cond:
                    results[i] = b
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self._threads)]
        for t in threads:
            t.start()
        try:
            for i in range(self._num):
                with cond:
                    while i not in results:
                        cond.wait()
                    b = results.pop(i)
                window.release()
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            consumed.set()
            for _ in threads:
                window.release()


def _paste(canvas, img):
    """Paste an RGB image at the canvas origin, clipped to the canvas."""
    ch, cw = min(img.shape[0], canvas.shape[0]), min(img.shape[1], canvas.shape[1])
    canvas[:ch, :cw] = img[:ch, :cw]


_decoder_reported = threading.Event()


def _native_loader(use_native: Optional[bool], num_threads: int):
    """The pipeline's native loader: None where ``use_native`` is False or,
    with ``use_native=None``, where the loader does not build here."""
    if use_native is False:
        return None
    if use_native:
        return native.NativeCanvasLoader(num_threads)
    try:
        loader = native.NativeCanvasLoader(num_threads)
    except (RuntimeError, OSError) as e:
        if not _decoder_reported.is_set():
            _decoder_reported.set()
            print(f"PosePipeline: decoding with cv2; the native loader is unavailable ({e})",
                  file=sys.stderr)
        return None
    if not _decoder_reported.is_set():
        _decoder_reported.set()
        print(f"PosePipeline: decoding JPEGs with the native loader ({loader.decoder})",
              file=sys.stderr)
    return loader


def _all_jpeg(paths) -> bool:
    return all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)


class PosePipeline:
    """Training/val batches from PoseRecords.

    :param canvas: fixed square canvas edge (COCO images are <= 640)
    :param process_index, process_count: this process's stride of the epoch
    :param dedup_canvases: canvas slots per batch (0 = one canvas per crop)
    :param dedup_buckets: per-device buckets the slots and crops are packed
        into, so a device's crops index only its own canvases
    :param use_native: decode JPEGs with the native loader (True: or raise;
        None: where it builds; False: never)
    """

    def __init__(self, records: Sequence[PoseRecord], batch_size: int,
                 input_shape=(192, 256), output_shape=(48, 64), canvas: int = 640,
                 augment: bool = True, shuffle: bool = True, seed: int = 1024,
                 num_threads: int = 8, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True, use_native: Optional[bool] = None,
                 dedup_canvases: int = 0, dedup_buckets: int = 1,
                 aug_scale=(0.7, 1.3), aug_rot=(-40, 40), aug_flip=True):
        self.records = list(records)
        self.batch_size = batch_size
        self.canvas = canvas
        self.augment = augment
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.transform = _SampleTransform(input_shape=input_shape, output_shape=output_shape,
                                          scale=tuple(aug_scale), rot=tuple(aug_rot),
                                          flip=bool(aug_flip))
        self.num_joints = self.records[0].joints.shape[0] if self.records else 17
        # canvas dedup: COCO averages ~2.3 instances/image, so shipping one
        # canvas per CROP wastes ~2x host decode + H2D.  Crops stay at
        # batch_size; slots and crops are packed per device bucket, and
        # "canvas_idx" holds bucket-local slot indices.
        self.dedup_canvases = int(dedup_canvases)
        self.dedup_buckets = max(1, int(dedup_buckets))
        if self.dedup_canvases and (batch_size % self.dedup_buckets
                                    or self.dedup_canvases % self.dedup_buckets):
            raise ValueError(f"batch_size {batch_size} and dedup_canvases {dedup_canvases} "
                             f"must divide into {self.dedup_buckets} buckets")
        self._native = _native_loader(use_native, num_threads)

    def batches_per_epoch(self) -> int:
        # every process must produce the SAME number of batches (they take
        # part in the same collectives): size off the global record count,
        # not this process's shard (which can differ by one)
        if self.drop_last:
            n_min = len(self.records) // self.process_count
            return n_min // self.batch_size
        n_max = -(-len(self.records) // self.process_count)
        return -(-n_max // self.batch_size)

    def _epoch_order(self, epoch: int, process_index: Optional[int] = None) -> np.ndarray:
        n = len(self.records)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        pi = self.process_index if process_index is None else process_index
        return order[pi::self.process_count]

    def _geometry(self, ridx: int, epoch: int):
        rng = np.random.default_rng((self.seed, epoch, int(ridx)))
        return self.transform(self.records[ridx], rng, self.augment)

    # per-record scalar extras of dedup batches (DetBoxPipeline: area and
    # score); their keys are listed in ``extra_keys``
    extra_keys: tuple = ()

    def _extra_fields(self, ridx: int) -> dict:
        return {}

    def _load_into(self, canvases, paths):
        """Decode ``paths`` into ``canvases[:len(paths)]`` (zeroed slots)."""
        if self._native is not None and paths and _all_jpeg(paths):
            canvases[:len(paths)] = self._native.load_batch(paths, self.canvas)[0]
        else:
            for slot, path in zip(canvases, paths):
                _paste(slot, _imread_rgb(path))

    # -- canvas dedup packing ------------------------------------------------

    def _pack_epoch(self, epoch: int, process_index: Optional[int] = None):
        """Greedy per-bucket packing plan (pure index math, no IO).

        Returns a list of batch plans; each plan is a list of dedup_buckets
        buckets, each bucket = (canvas_paths, crops) with crops a list of
        (local_canvas_slot, record_idx | None).  None = padded crop slot
        (canvas slots ran out on a run of single-instance images); padded
        crops carry zero joints so the loss mask drops them.
        """
        order = self._epoch_order(epoch, process_index)
        # instance groups by source image, ordered by first appearance
        by_img: dict = {}
        for ridx in order:
            by_img.setdefault(self.records[int(ridx)].img_path, []).append(int(ridx))
        groups = list(by_img.items())
        n = self.dedup_buckets
        cap_crops = self.batch_size // n
        cap_canv = self.dedup_canvases // n
        plans = []
        gi = 0
        carry = None  # remainder of a split group: (path, insts)
        while True:
            plan = []
            exhausted = False
            for _ in range(n):
                canv, crops = [], []
                while len(crops) < cap_crops:
                    if carry is not None:
                        (path, insts), carry = carry, None
                    elif gi < len(groups):
                        path, insts = groups[gi]
                        gi += 1
                    else:
                        exhausted = True
                        break
                    if len(canv) == cap_canv:
                        carry = (path, insts)  # no slot left; bucket pads
                        break
                    room = cap_crops - len(crops)
                    take, rest = insts[:room], insts[room:]
                    ci = len(canv)
                    canv.append(path)
                    crops.extend((ci, r) for r in take)
                    if rest:  # image spills into the next bucket/batch
                        carry = (path, rest)
                        break
                crops += [(0, None)] * (cap_crops - len(crops))  # pad (valid=0)
                plan.append((canv, crops))
            if exhausted and self.drop_last:
                break
            plans.append(plan)
            if exhausted or (gi >= len(groups) and carry is None):
                break
        return plans

    def dedup_batches_per_epoch(self, epoch: int) -> int:
        """Packed batch count, equalized across processes (each packs every
        process's plan -- cheap index math), so collectives can't deadlock on
        a skewed instance distribution: the min with ``drop_last`` (as the
        JAX pipeline), else the max, a process short of batches padding
        with empty ones, so that no record is dropped (the JAX pipeline
        takes the min here too and loses the last records of a process)."""
        counts = [len(self._pack_epoch(epoch, process_index=h))
                  for h in range(self.process_count)]
        return min(counts) if self.drop_last else max(counts)

    def _dedup_epoch(self, epoch: int) -> Iterator[dict]:
        plans = self._pack_epoch(epoch)
        nb = self.dedup_batches_per_epoch(epoch) if self.process_count > 1 else len(plans)
        empty = [([], [(0, None)] * (self.batch_size // self.dedup_buckets))]
        plans += [empty * self.dedup_buckets] * (nb - len(plans))
        cap_canv = self.dedup_canvases // self.dedup_buckets
        bs, U = self.batch_size, self.dedup_canvases
        ident = np.array([[1, 0, 0], [0, 1, 0]], np.float32)

        def make_batch(bi):
            batch = {
                "canvas": np.zeros((U, self.canvas, self.canvas, 3), dtype=np.uint8),
                "canvas_idx": np.zeros((bs,), dtype=np.int32),
                "trans": np.zeros((bs, 2, 3), dtype=np.float32),
                "joints": np.zeros((bs, self.num_joints, 3), dtype=np.float32),
                "trans_inv": np.zeros((bs, 2, 3), dtype=np.float32),
                "img_id": np.zeros((bs,), dtype=np.int64),
                "valid": np.zeros((bs,), dtype=np.float32),
                **{key: np.zeros((bs,), dtype=np.float32) for key in self.extra_keys},
            }
            k = 0
            for b, (canv, crops) in enumerate(plans[bi]):
                self._load_into(batch["canvas"][b * cap_canv:(b + 1) * cap_canv], canv)
                for ci, ridx in crops:
                    batch["canvas_idx"][k] = ci  # bucket-LOCAL slot index
                    if ridx is not None:
                        batch["trans"][k], batch["joints"][k], batch["trans_inv"][k] = (
                            self._geometry(ridx, epoch))
                        batch["img_id"][k] = self.records[ridx].img_id
                        batch["valid"][k] = 1.0
                        for key, val in self._extra_fields(ridx).items():
                            batch[key][k] = val
                    else:  # padded slot: identity crop, zero joints
                        batch["trans"][k] = batch["trans_inv"][k] = ident
                    k += 1
            return batch

        return iter(_Prefetcher(make_batch, nb, self.num_threads, self.prefetch))

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        if self.dedup_canvases:
            return self._dedup_epoch(epoch)
        order = self._epoch_order(epoch)
        bs = self.batch_size

        def make_batch(bi):
            idxs = order[bi * bs:(bi + 1) * bs]
            real = len(idxs)
            if real < bs:  # pad to fixed shape; mask via 'valid'
                filler = idxs[-1:] if real else (order[-1:] if len(order) else np.array([0]))
                idxs = np.concatenate([idxs, np.repeat(filler, bs - real)])
            batch = {
                "canvas": np.zeros((bs, self.canvas, self.canvas, 3), dtype=np.uint8),
                "trans": np.zeros((bs, 2, 3), dtype=np.float32),
                "joints": np.zeros((bs, self.num_joints, 3), dtype=np.float32),
                "trans_inv": np.zeros((bs, 2, 3), dtype=np.float32),
                "img_id": np.zeros((bs,), dtype=np.int64),
                "valid": np.zeros((bs,), dtype=np.float32),
            }
            self._load_into(batch["canvas"], [self.records[r].img_path for r in idxs])
            for k, ridx in enumerate(idxs):
                rec = self.records[ridx]
                batch["trans"][k], batch["joints"][k], batch["trans_inv"][k] = (
                    self._geometry(ridx, epoch))
                batch["img_id"][k] = rec.img_id
                batch["valid"][k] = 1.0 if k < real else 0.0
            return batch

        return iter(_Prefetcher(make_batch, self.batches_per_epoch(), self.num_threads,
                                self.prefetch))


class DetBoxPipeline(PosePipeline):
    """Eval batches from detector boxes (datasets/naive_data.py BasicTransform:
    identity augmentation), with each instance's area = scale_w * scale_h of
    its box and its detector score.  JAX data/pipeline.py:414-471."""

    extra_keys = ("area", "score")

    def __init__(self, records: Sequence[DetBoxRecord], batch_size: int, **kw):
        kw.setdefault("augment", False)
        kw.setdefault("shuffle", False)
        kw.setdefault("drop_last", False)
        pose_records = [PoseRecord(r.img_path, 0, 0, r.box, np.zeros((17, 3), np.float32),
                                   r.img_id) for r in records]
        super().__init__(pose_records, batch_size, **kw)
        self.det_records = list(records)

    def _center_scale(self, ridx: int):
        x1, y1, x2, y2 = self.det_records[int(ridx)].box
        return A.box_to_center_scale(x1, y1, x2 - x1, y2 - y1, self.transform.w_h_ratio)

    def _geometry(self, ridx: int, epoch: int):
        center, scale = self._center_scale(ridx)
        trans, _ = A.get_affine_transform(center, scale, 0, self.transform.input_shape)
        _, trans_inv = A.get_affine_transform(center, scale, 0, self.transform.output_shape)
        joints = np.zeros((self.num_joints, 3), dtype=np.float32)
        return trans.astype(np.float32), joints, np.asarray(trans_inv, np.float32)

    def _extra_fields(self, ridx: int) -> dict:
        _, scale = self._center_scale(ridx)
        return {"area": scale[0] * scale[1], "score": self.det_records[int(ridx)].score}

    def epoch(self, epoch: int = 0):
        if self.dedup_canvases:  # the extras flow through _extra_fields
            return self._dedup_epoch(epoch)
        return self._detbox_epoch(epoch)

    def _detbox_epoch(self, epoch: int):
        # the parent's batching of this process's epoch order, so that area
        # and score stay aligned with the crops (padding repeats the last)
        order = self._epoch_order(epoch)
        bs = self.batch_size
        for bi, batch in enumerate(super().epoch(epoch)):
            idxs = order[bi * bs:(bi + 1) * bs]
            if len(idxs) < bs:
                filler = idxs[-1:] if len(idxs) else (order[-1:] if len(order) else np.array([0]))
                idxs = np.concatenate([idxs, np.repeat(filler, bs - len(idxs))])
            batch["area"] = np.zeros((bs,), dtype=np.float32)
            batch["score"] = np.zeros((bs,), dtype=np.float32)
            for k, ridx in enumerate(idxs):
                for key, val in self._extra_fields(ridx).items():
                    batch[key][k] = val
            yield batch
