"""The serving run: one client in a closed loop (the next request is sent
when the previous one's detections are on the host), for ``--seconds``.

``entry``: ``blobs`` sends a request of preprocessed uint8 blobs of one
bucket to ``Detector.detect_blobs`` and reads (dets, valid) back with
``.cpu()``; ``images`` sends raw BGR images to ``Detector.__call__``, which
resizes, pads, groups by bucket, detects and reads back.  A request's time
runs from the call to its detections on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import program, traffic
from benchmark.harness.check import detection_readings
from benchmark.harness.weights import make_weights
from benchmark.reference import data as refdata
from benchmark.reference.detector import Net


class ServeCell:
    kind = "serve"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        self.c = program.settings(cell.config, self.t, seed)

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from frcnn_tpu_torch.engine.serve import Detector

        conf, c, t = self.cell.config, self.c, self.t
        self.weights = make_weights(conf["net"], conf["num_classes"], c, self.seed, self.device,
                                    conf.get("weights"))
        model, cfg = program.build(conf, c, self.weights, self.device)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        self.detector = Detector(model, cfg, uint8_input=t["entry"] == "blobs", device=self.device)
        pool = traffic.serve_pool(t, self.seed, self.device)
        target, max_size, buckets = c["TEST.SCALES"][0], c["TEST.MAX_SIZE"], c["DEVICE.BUCKETS"]

        def bucket_of(shape):
            return refdata.scale_and_bucket(*shape, target, max_size, buckets)[1]

        plan = traffic.request_plan(t, [im.shape[:2] for im in pool], self.seed, bucket_of)
        if t["entry"] == "blobs":
            prepped = [refdata.prep(im, target, max_size, buckets, keep_uint8=True) for im in pool]
            self.requests = [(np.stack([prepped[i][0] for i in idx]),
                              np.stack([prepped[i][1] for i in idx])) for idx in plan]
        else:
            self.requests = [[pool[i] for i in idx] for idx in plan]
        self._warm(buckets)

    def _warm(self, buckets):
        """Every key the traffic can produce captured and replayed twice."""
        k = self.t["request_images"]
        if self.t["entry"] == "blobs":
            keys = {(k, tuple(b)) for b in buckets}
        else:
            keys = {(n, tuple(b)) for n in range(1, k + 1) for b in buckets}
        dtype = np.uint8 if self.t["entry"] == "blobs" else np.float32
        for n, (bh, bw) in sorted(keys):
            data = np.zeros((n, bh, bw, 3), dtype)
            info = np.tile(np.array([[bh, bw, 1.0]], np.float32), (n, 1))
            for _ in range(2):
                dets, valid = self.detector.detect_blobs(data, info)
                dets.cpu(), valid.cpu()
        for payload in self.requests[:2]:
            self._call(payload)

    # -- the timed path ---------------------------------------------------------
    def _call(self, payload):
        if self.t["entry"] == "blobs":
            dets, valid = self.detector.detect_blobs(*payload)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            return [d[v] for d, v in zip(dets, valid)]
        return self.detector(payload)

    def window(self, seconds: float, count: int | None = None):
        """Closed loop for ``seconds`` (or ``count`` requests): [(request
        index, start, end, per-image detections)]."""
        recs, n_req = [], len(self.requests)
        start = time.perf_counter()
        i = 0
        while (count is None and time.perf_counter() - start < seconds) or (
                count is not None and i < count):
            t0 = time.perf_counter()
            out = self._call(self.requests[i % n_req])
            recs.append((i % n_req, t0, time.perf_counter(), out))
            i += 1
        return recs

    def images_of(self, rec) -> int:
        return len(self.requests[rec[0]][0]) if self.t["entry"] == "blobs" \
            else len(self.requests[rec[0]])

    def end_to_end(self, recs) -> dict:
        span = recs[-1][2] - recs[0][1]
        images = sum(self.images_of(r) for r in recs)
        lat = [1e3 * (r[2] - r[1]) for r in recs]
        names = self.t["metrics"]
        out = {names["rate"]: traffic.rate(images, span)}
        if "p95" in names:
            out[names["p95"]] = traffic.percentile(lat, 95)
        return out

    def batches(self, recs):
        """(B, bucket) of every ``detect`` the requests ran."""
        out = []
        c = self.c
        for r in recs:
            if self.t["entry"] == "blobs":
                data = self.requests[r[0]][0]
                out.append((data.shape[0], data.shape[1:3]))
            else:
                groups: dict = {}
                for im in self.requests[r[0]]:
                    b = refdata.scale_and_bucket(*im.shape[:2], c["TEST.SCALES"][0],
                                                 c["TEST.MAX_SIZE"], c["DEVICE.BUCKETS"])[1]
                    groups[tuple(b)] = groups.get(tuple(b), 0) + 1
                out += [(n, b) for b, n in groups.items()]
        return out

    def free(self):
        del self.detector

    # -- the check -------------------------------------------------------------
    def sample(self, recs):
        rng = np.random.RandomState((self.seed + 2) % 2**32)
        n = min(self.t["sample_requests"], len(recs))
        return [recs[i] for i in sorted(rng.choice(len(recs), n, replace=False))]

    def reference_answers(self, ref, payload):
        """The reference ``ref``'s per-image detections of one request."""
        c = self.c
        with torch.no_grad():
            if self.t["entry"] == "blobs":
                data, info = (torch.as_tensor(x).to(self.device) for x in payload)
                dets, valid = ref.detect(data, info)
                return [d[v].cpu().numpy() for d, v in zip(dets, valid)]
            out = [None] * len(payload)
            groups: dict = {}
            for i, im in enumerate(payload):
                blob, info = refdata.prep(im, c["TEST.SCALES"][0], c["TEST.MAX_SIZE"],
                                          c["DEVICE.BUCKETS"])
                groups.setdefault(blob.shape[:2], []).append((i, blob, info))
            for group in groups.values():
                data = torch.as_tensor(np.stack([g[1] for g in group])).to(self.device)
                info = torch.as_tensor(np.stack([g[2] for g in group])).to(self.device)
                dets, valid = ref.detect(data, info)
                for (i, _, _), d, v in zip(group, dets, valid):
                    out[i] = d[v].cpu().numpy()
            return out

    def readings(self, recs, quant=None) -> dict:
        """The check's numbers over the sampled requests: the program's
        answers against the float32 reference's; with ``quant`` the
        reference at that precision stands in for the program."""
        conf = self.cell.config
        W = {k: v.to(self.device) for k, v in self.weights.items()}
        ref = Net(W, self.c, conf["net"], conf["num_classes"])
        low = Net(W, self.c, conf["net"], conf["num_classes"], quant) if quant else None
        prog, want, parts = [], [], []
        for rec in self.sample(recs):
            payload = self.requests[rec[0]]
            want += self.reference_answers(ref, payload)
            prog += rec[3] if low is None else self.reference_answers(low, payload)
            parts += self.parts(payload)
        return detection_readings(prog, want, parts)

    def parts(self, payload):
        """Each image's batch slot and bucket: its row in the request's
        batch (``blobs``), or its rank among the request's images of its
        bucket, which ``Detector`` batches together in request order."""
        if self.t["entry"] == "blobs":
            bucket = tuple(payload[0].shape[1:3])
            return [(("slot", j), ("bucket", bucket)) for j in range(len(payload[0]))]
        c, seen, out = self.c, {}, []
        for im in payload:
            b = tuple(refdata.scale_and_bucket(*im.shape[:2], c["TEST.SCALES"][0],
                                               c["TEST.MAX_SIZE"], c["DEVICE.BUCKETS"])[1])
            out.append((("slot", seen.get(b, 0)), ("bucket", b)))
            seen[b] = seen.get(b, 0) + 1
        return out
