// Host-side native ops: greedy NMS and pairwise IoU.
//
// The port's copy of frcnn_tpu/native/host_ops.cc, the same code: the
// counterpart of the reference's CPU native layer (lib/nms/cpu_nms.pyx +
// lib/utils/bbox.pyx).  The card's path runs its own kernels; host-side
// tooling (apply_nms over pickled detections in tools/reval.py, the demo)
// runs these.  A plain C ABI for ctypes (host_ops.py), built with g++ at
// first use (native/build.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy hard-NMS over score-DESC-sorted dets (n x 5: x1,y1,x2,y2,score).
// If not sorted, pass sorted=0 and it sorts internally.  Writes kept
// indices (original order) to keep_out (capacity n); returns kept count.
int frcnn_nms(const float* dets, int64_t n, float thresh, int sorted_flag,
              int64_t* keep_out) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  if (!sorted_flag) {
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return dets[a * 5 + 4] > dets[b * 5 + 4];
    });
  }
  std::vector<float> areas(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + 1.0f) * (d[3] - d[1] + 1.0f);
  }
  std::vector<char> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* di = dets + i * 5;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      int64_t j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      float xx1 = std::max(di[0], dj[0]);
      float yy1 = std::max(di[1], dj[1]);
      float xx2 = std::min(di[2], dj[2]);
      float yy2 = std::min(di[3], dj[3]);
      float w = std::max(0.0f, xx2 - xx1 + 1.0f);
      float h = std::max(0.0f, yy2 - yy1 + 1.0f);
      float inter = w * h;
      float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return static_cast<int>(kept);
}

// Pairwise IoU: boxes (n x 4) vs query (k x 4) -> out (n x k), inclusive
// corners (reference bbox_overlaps semantics).
void frcnn_bbox_overlaps(const float* boxes, int64_t n, const float* query,
                         int64_t k, float* out) {
  for (int64_t j = 0; j < k; ++j) {
    const float* q = query + j * 4;
    float qarea = (q[2] - q[0] + 1.0f) * (q[3] - q[1] + 1.0f);
    for (int64_t i = 0; i < n; ++i) {
      const float* b = boxes + i * 4;
      float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.0f;
      float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.0f;
      float v = 0.0f;
      if (iw > 0.0f && ih > 0.0f) {
        float barea = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
        float inter = iw * ih;
        v = inter / (barea + qarea - inter);
      }
      out[i * k + j] = v;
    }
  }
}

}  // extern "C"
