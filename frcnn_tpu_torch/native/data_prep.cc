// Native minibatch image preparation: decode + flip + f32 resize + pad,
// threaded across the batch.
//
// The port's copy of frcnn_tpu/native/data_prep.cc, the same code: the hot
// host path of the reference's data layer (lib/roi_data_layer/minibatch.py
// cv2.imread + lib/utils/blob.py prep_im_for_blob), off the GIL.  Built on
// the system OpenCV with the op order of the Python path (flip BEFORE the
// float conversion, f32 INTER_LINEAR resize with fx/fy).  The port's Python
// path resizes in numpy with cv2's sampling; the two agree within rtol 1e-4,
// atol 0.05 (tests/test_torch_native.py); im_info and gt are exact.
//
// C API (ctypes, see data_prep.py):
//   frcnn_prep_batch(paths, flips, scales, n, bh, bw, out, out_dims,
//                    n_threads)
//     paths:   n C strings (image files, any OpenCV-decodable format)
//     flips:   n ints (nonzero -> horizontal flip)
//     scales:  n floats (resize factor from the Python side's
//              pick_scale_and_bucket: the bucket needs only the roidb
//              entry's stored width/height, not the pixels)
//     out:     n * bh * bw * 3 floats, written zero-padded (BGR)
//     out_dims: n * 2 ints, the resized (h, w) per image
//   returns 0 on success, -1-i for a failed image i.

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int frcnn_prep_batch(const char** paths, const int* flips,
                     const float* scales, int n, int bh, int bw, float* out,
                     int* out_dims, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = n;

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() >= 0) return;
      cv::Mat im = cv::imread(paths[i], cv::IMREAD_COLOR);
      if (im.empty()) {
        failed.store(i);
        return;
      }
      if (flips[i]) cv::flip(im, im, 1);  // same as python im[:, ::-1, :]
      cv::Mat imf;
      im.convertTo(imf, CV_32FC3);  // python: im.astype(np.float32) first
      cv::Mat resized;
      cv::resize(imf, resized, cv::Size(), scales[i], scales[i],
                 cv::INTER_LINEAR);
      int rh = resized.rows, rw = resized.cols;
      if (rh > bh || rw > bw) {  // bucket must cover the scaled image
        failed.store(i);
        return;
      }
      out_dims[2 * i] = rh;
      out_dims[2 * i + 1] = rw;
      float* dst = out + static_cast<int64_t>(i) * bh * bw * 3;
      std::memset(dst, 0, sizeof(float) * bh * bw * 3);
      for (int r = 0; r < rh; ++r) {
        std::memcpy(dst + static_cast<int64_t>(r) * bw * 3,
                    resized.ptr<float>(r), sizeof(float) * rw * 3);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  int f = failed.load();
  return f >= 0 ? -1 - f : 0;
}

}  // extern "C"
