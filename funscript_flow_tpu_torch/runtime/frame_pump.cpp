// frame_pump — native host-side video decode + preprocess runtime (the
// PyTorch port's copy of the JAX package's runtime/frame_pump.cpp).
//
// The pipeline's host boundary is "fixed-size uint8 frame batches"
// (funscript_flow_tpu_torch.io.decode). The pure-Python source pays GIL +
// per-frame Python overhead; this C++ runtime runs the whole
// decode->resize->crop->gray chain on native threads and hands Python
// finished batches.
//
// Two decode engines behind one pump interface:
//
//  * EXACT (OpenCV VideoCapture, same codecs the reference used through cv2
//    bindings: FunscriptFlow.pyw:103-291): full-resolution decode, cv2
//    INTER_LINEAR resize, BGR2GRAY — bit-identical to the Python path.
//  * FAST (libav direct): the analysis plane is only 256x256 gray, so the
//    decoder is told as much — AV_CODEC_FLAG_GRAY skips chroma entirely and
//    `lowres` decodes mpegvideo-family codecs at 1/2^k resolution straight
//    out of the IDCT (largest k that still covers the analysis resolution).
//    The luma plane goes through one swscale bilinear pass to 256x256 and a
//    256-entry LUT that applies the same limited->full range expansion cv2's
//    YUV->BGR->GRAY chain performs ((y-16)*255/219 for MPEG-range streams).
//    Numerics are validated against the exact path at the frame level and at
//    the funscript level (tests/test_torch_runtime.py); codecs that reject
//    any of it fall back to the exact engine automatically.
//
// The exact engine is compiled only with FF_PUMP_EXACT defined (the
// builder, runtime/_build.py, defines it when OpenCV's headers are found).
// Without it the library needs libav alone and holds only the fast engine:
// an open the fast engine cannot serve (a caller asking for fast=0 or RGB
// output, or a codec that rejects lowres/gray) then fails, and
// fp_last_error() says why; it never switches engines.
//
// Architecture: one decoder thread per pump does a single sequential pass
// (no POS_FRAMES seeking per frame, unlike the reference's seek-per-frame
// pool, :177-178), preprocesses into pooled frame buffers, and feeds a
// bounded queue. fp_next_batch() memcpy's up to N frames into the caller's
// pinned numpy buffer. Failure semantics match the Python path: short
// container -> clean EOF; failed retrieve -> black frame.
//
// C ABI (ctypes): fp_open / fp_open_range / fp_open_v2 / fp_meta /
// fp_next_batch / fp_cancel / fp_close, and fp_has_exact / fp_last_error.

#ifdef FF_PUMP_EXACT
#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>
#endif

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/display.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Why the calling thread's last fp_open* returned nullptr.
thread_local std::string g_last_error;

constexpr int kOutSize = 256;   // analysis resolution (SURVEY.md §6)
constexpr int kVrSize = 512;    // VR: resize 512, crop bottom-left quadrant

// ---------------------------------------------------------------------------
// FAST engine: libav decode tuned for "256x256 gray is all we need".
// ---------------------------------------------------------------------------
// cv2-exact fixed-point bilinear resize plan: precomputed per-axis sample
// positions + short coefficients (INTER_RESIZE_COEF_SCALE = 2048), matching
// OpenCV's 8U INTER_LINEAR path bit-for-bit (hresize int accumulate, then
// the (((b0*(r0>>4))>>16) + ((b1*(r1>>4))>>16) + 2) >> 2 vertical combine).
struct ResizePlan {
  int sw = 0, sh = 0;          // source (crop) dims the plan was built for
  int sx[kOutSize];
  short a0[kOutSize], a1[kOutSize];
  int sy[kOutSize];
  short b0[kOutSize], b1[kOutSize];

  static void axis(int n_src, int* s, short* c0, short* c1) {
    const double scale = (double)n_src / kOutSize;
    for (int d = 0; d < kOutSize; d++) {
      double f = (d + 0.5) * scale - 0.5;
      int si = (int)std::floor(f);
      f -= si;
      if (si < 0) { si = 0; f = 0.0; }
      if (si >= n_src - 1) {
        si = n_src >= 2 ? n_src - 2 : 0;
        f = n_src >= 2 ? 1.0 : 0.0;
      }
      s[d] = si;
      c0[d] = (short)std::lrint((1.0 - f) * 2048.0);
      c1[d] = (short)std::lrint(f * 2048.0);
    }
  }

  void build(int n_sw, int n_sh) {
    sw = n_sw;
    sh = n_sh;
    axis(sw, sx, a0, a1);
    axis(sh, sy, b0, b1);
  }

  // src: crop origin pointer, ``stride`` bytes/row; ``lut`` applied to the
  // four samples BEFORE interpolation (cv2's exact path range-expands per
  // source pixel, then resizes — same order).
  void run(const unsigned char* src, int stride, const unsigned char* lut,
           unsigned char* out) const {
    int row0[kOutSize], row1[kOutSize];
    for (int dy = 0; dy < kOutSize; dy++) {
      const unsigned char* s0 = src + (size_t)sy[dy] * stride;
      const unsigned char* s1 = s0 + (sh >= 2 ? stride : 0);
      for (int dx = 0; dx < kOutSize; dx++) {
        const int x0 = sx[dx], x1 = sw >= 2 ? x0 + 1 : x0;
        row0[dx] = lut[s0[x0]] * a0[dx] + lut[s0[x1]] * a1[dx];
        row1[dx] = lut[s1[x0]] * a0[dx] + lut[s1[x1]] * a1[dx];
      }
      const int bb0 = b0[dy], bb1 = b1[dy];
      unsigned char* o = out + (size_t)dy * kOutSize;
      for (int dx = 0; dx < kOutSize; dx++) {
        o[dx] = (unsigned char)((((bb0 * (row0[dx] >> 4)) >> 16) +
                                 ((bb1 * (row1[dx] >> 4)) >> 16) + 2) >> 2);
      }
    }
  }
};

// Clockwise display rotation {0,90,180,270} from a stream's display-matrix
// side data. av_display_rotation_get returns counterclockwise degrees;
// verified against players/cv2 5.x: a phone portrait clip (mp4 rotate tag
// 90) yields theta=-90 here and displays rotated 90 clockwise.
static int stream_rotation_cw(AVStream* st) {
  const uint8_t* sd =
      av_stream_get_side_data(st, AV_PKT_DATA_DISPLAYMATRIX, nullptr);
  if (!sd) return 0;
  const double theta =
      av_display_rotation_get(reinterpret_cast<const int32_t*>(sd));
  const int r = ((-(int)std::lround(theta)) % 360 + 360) % 360;
  return (r % 90 == 0) ? r : 0;  // shear matrices (rare): ignore, as players do
}

#ifdef FF_PUMP_EXACT
// Same, opening ``path`` fresh — for the exact (OpenCV) engine, whose
// VideoCapture exposes rotation only through version-inconsistent
// properties (see fp_open_impl).
static int display_rotation_cw(const char* path) {
  AVFormatContext* f = nullptr;
  if (avformat_open_input(&f, path, nullptr, nullptr) < 0) return 0;
  int rot = 0;
  if (avformat_find_stream_info(f, nullptr) >= 0) {
    const int vs = av_find_best_stream(f, AVMEDIA_TYPE_VIDEO, -1, -1,
                                       nullptr, 0);
    if (vs >= 0) rot = stream_rotation_cw(f->streams[vs]);
  }
  avformat_close_input(&f);
  return rot;
}
#endif  // FF_PUMP_EXACT

struct LavDecoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  const AVCodec* codec = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frm = nullptr;
  int vs = -1;
  AVRational tb{1, 1};
  AVRational frame_rate{0, 1};
  double fps = 0.0;
  long long total_frames = 0;
  int src_w = 0, src_h = 0;
  int64_t stream_start = 0;
  long long frame_idx = -1;   // presentation index of the last decoded frame
  bool draining = false;
  unsigned char lut[256];
  bool use_lut = false;
  ResizePlan plan;
  std::vector<unsigned char> depth_buf;  // 8-bit luma scratch for >8-bit content
  std::vector<unsigned char> rot_buf;    // rotated-plane scratch
  // Display-matrix rotation normalized to {0, 90, 180, 270}, where the
  // value is the CLOCKWISE rotation that produces the displayed frame —
  // cv2's auto-orientation (the exact engine and the reference's decoder)
  // applies it, so the fast engine must match frame-for-frame.
  int rot = 0;
  // Grid-aware frame skipping: when set (step > 1), packets whose pts maps
  // off the sampling grid decode with skip_frame = AVDISCARD_NONREF — the
  // decoder drops them outright when they're not reference frames (h264
  // B-frames: ~half of typical long-GOP content, at near-zero cost), and
  // still decodes them when later frames depend on them. Grid packets
  // always decode (AVDISCARD_DEFAULT), so emitted frames are unaffected.
  int skip_step = 1;
  long long skip_first = 0;
  // pts->index calibration: containers that synthesize pts from dts under
  // B-frame reorder delay (AVI) label every displayed frame one tick late,
  // which would shift the sampling grid for step > 1 and break the
  // range-slice == full-read-slice invariant. The first displayed frame is
  // by definition index 0; whatever raw index it reports is the offset.
  long long idx_offset = 0;
  bool pending = false;  // frm holds an undelivered frame (open calibration
                         // or seek verification); next_frame() returns it

  std::string why;  // why open() failed

  bool fail(const char* reason) {
    why = reason;
    return false;
  }

  ~LavDecoder() { close(); }

  void close() {
    if (frm) av_frame_free(&frm);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
  }

  long long pts_to_index(int64_t ts) const {
    return std::llround((ts - stream_start) * av_q2d(tb) * fps) - idx_offset;
  }

  bool open(const char* path, bool vr_mode) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
      return fail("libav cannot open the file");
    if (avformat_find_stream_info(fmt, nullptr) < 0)
      return fail("libav finds no stream info");
    vs = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (vs < 0) return fail("no video stream");
    AVStream* st = fmt->streams[vs];
    codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) return fail("libav has no decoder for the codec");
    ctx = avcodec_alloc_context3(codec);
    if (!ctx || avcodec_parameters_to_context(ctx, st->codecpar) < 0)
      return fail("cannot set up the decoder");

    src_w = st->codecpar->width;
    src_h = st->codecpar->height;
    if (src_w <= 0 || src_h <= 0) return fail("the stream has no frame size");

    // Display-matrix rotation: reported metadata (and the VR crop) are in
    // DISPLAY orientation, like cv2 >= 4.7 auto-orientation reports them.
    rot = stream_rotation_cw(st);
    if (rot == 90 || rot == 270) std::swap(src_w, src_h);

    // Largest lowres level that still covers the analysis plane: the decoded
    // frame (VR: its bottom-left quadrant) must stay >= 256 per side.
    const int min_side = vr_mode ? 2 * kOutSize : kOutSize;
    int k = 0;
    while (k < codec->max_lowres &&
           (src_w >> (k + 1)) >= min_side && (src_h >> (k + 1)) >= min_side) {
      k++;
    }
    ctx->lowres = k;
    ctx->flags |= AV_CODEC_FLAG_GRAY;           // skip chroma decode
    ctx->flags2 |= AV_CODEC_FLAG2_FAST;
    // Deblocking policy (fast engine only — this whole decoder is the fast
    // path). Default: skipped only for frames nothing else predicts from —
    // a non-reference frame's missing loop filter perturbs that frame's
    // own pixels slightly but can never accumulate across the GOP (unlike
    // AVDISCARD_ALL, which was measured at +16% speed but drifts on long
    // GOPs — see NOTES_ROUND3). Reference frames stay bit-exact.
    //
    // At >=6 MP decoded luma (4K-class: the SBS-VR premium workload,
    // reference FunscriptFlow.pyw:1076-1079) the policy flips to
    // AVDISCARD_ALL: there decode IS the single-core bottleneck (measured
    // 2.9x-realtime ceiling for 4K SBS), ALL buys +10-20%, and the drift
    // stays inside the fast envelope after the >=7x downscale to the
    // analysis plane (measured on adversarial oscillating-zoom 4K: per-
    // frame residual 1.50 -> 1.79 gray levels across a 250-frame GOP,
    // funscript pos |d| max 5 vs exact where NONREF gives 3 —
    // NOTES_ROUND4). FF_PUMP_SLF=all|nonref|off overrides either way.
    const long long luma_px = (long long)(src_w >> k) * (long long)(src_h >> k);
    ctx->skip_loop_filter =
        luma_px >= 6000000LL ? AVDISCARD_ALL : AVDISCARD_NONREF;
    if (const char* slf = getenv("FF_PUMP_SLF")) {
      if (!strcmp(slf, "all")) ctx->skip_loop_filter = AVDISCARD_ALL;
      else if (!strcmp(slf, "nonref")) ctx->skip_loop_filter = AVDISCARD_NONREF;
      else if (!strcmp(slf, "off")) ctx->skip_loop_filter = AVDISCARD_NONE;
    }
    unsigned hc = std::thread::hardware_concurrency();
    ctx->thread_count = static_cast<int>(std::min(4u, hc ? hc : 1u));
    if (avcodec_open2(ctx, codec, nullptr) < 0)
      return fail("the codec rejects lowres/gray decode");

    tb = st->time_base;
    stream_start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
    AVRational fr = st->avg_frame_rate;
    if (fr.num <= 0 || fr.den <= 0) fr = av_guess_frame_rate(fmt, st, nullptr);
    frame_rate = fr;
    fps = (fr.num > 0 && fr.den > 0) ? av_q2d(fr) : 0.0;
    total_frames = st->nb_frames;
    if (total_frames <= 0 && fps > 0 && fmt->duration > 0) {
      total_frames = static_cast<long long>(
          std::llround(fmt->duration / (double)AV_TIME_BASE * fps));
    }
    if (fps <= 0.0 || total_frames <= 0)
      return fail("the stream has no frame rate or frame count");

    // cv2's YUV->BGR applies MPEG(limited)->full range; replicate on luma.
    const AVColorRange cr = st->codecpar->color_range;
    use_lut = (cr != AVCOL_RANGE_JPEG);
    for (int i = 0; i < 256; i++) {
      double v = use_lut ? (i - 16.0) * 255.0 / 219.0 : (double)i;
      lut[i] = static_cast<unsigned char>(std::min(255.0, std::max(0.0, std::round(v))));
    }
    pkt = av_packet_alloc();
    frm = av_frame_alloc();
    if (!pkt || !frm) return fail("out of memory");
    // Calibrate idx_offset from the first displayed frame (see the field
    // comment). skip_step is still 1 here, so nothing is grid-dropped. The
    // frame stays pending, so full reads lose nothing and range opens just
    // discard it at seek_to().
    if (next_frame()) {
      idx_offset = frame_idx;  // raw: idx_offset was 0 inside pts_to_index
      frame_idx = 0;
      pending = true;
    }
    return true;
  }

  // Frame-accurate positioning: keyframe seek, decode-verified. Leaves the
  // first decoded frame (index <= target) pending so the caller's skip loop
  // advances from it to the exact target.
  bool seek_to(long long target) {
    if (target <= 0) return true;
    long long back = 0;
    while (true) {
      long long t = target - back;
      if (t < 0) t = 0;
      // Exact rational rescale, rounded DOWN: frame i's timestamp is
      // i * (1/frame_rate) in tb units. llround(fps * tb.num) could round
      // the denominator down for non-broadcast rates (~12.3 fps),
      // overshooting the target. Rounding down at worst lands one frame
      // early, which the decode-skip loop absorbs.
      const int64_t ts = stream_start + av_rescale_q_rnd(
          t + idx_offset, av_inv_q(frame_rate), tb, AV_ROUND_DOWN);
      if (av_seek_frame(fmt, vs, ts, AVSEEK_FLAG_BACKWARD) < 0) return false;
      avcodec_flush_buffers(ctx);
      draining = false;
      pending = false;
      frame_idx = -1;  // re-derived from the first decoded frame's pts
      if (t == 0) return true;  // stream start: nothing earlier exists
      // Decode-verify: MPEG-PS/TS carry no keyframe index, so BACKWARD can
      // land *past* the target and the range shard would silently emit
      // later frames. Reference frames always decode (grid-skip only drops
      // non-refs), so the keyframe at/below the landing point comes out.
      if (next_frame() && frame_idx <= target) {
        pending = true;
        return true;
      }
      back = back == 0 ? (long long)(fps > 0.0 ? fps : 30.0) : back * 4;
    }
  }

  // Decodes the next (undropped) frame in presentation order into frm;
  // returns false at EOF. frame_idx is pts-derived whenever a timestamp is
  // available (required once grid-skip may drop frames between two emitted
  // ones), falling back to increment for timestamp-less streams.
  bool next_frame() {
    if (pending) {
      pending = false;
      return true;
    }
    while (true) {
      int r = avcodec_receive_frame(ctx, frm);
      if (r == 0) {
        int64_t ts = frm->best_effort_timestamp;
        if (ts != AV_NOPTS_VALUE) {
          frame_idx = pts_to_index(ts);
        } else {
          frame_idx++;
        }
        return true;
      }
      if (r == AVERROR_EOF) return false;
      if (r != AVERROR(EAGAIN)) return false;
      if (draining) return false;
      // feed one more packet
      while (true) {
        int pr = av_read_frame(fmt, pkt);
        if (pr < 0) {
          draining = true;
          avcodec_send_packet(ctx, nullptr);
          break;
        }
        if (pkt->stream_index == vs) {
          if (skip_step > 1) {
            // Per-packet skip: frame threading copies skip_frame into the
            // worker context at submit time (pthread_frame.c
            // update_context_from_user), so the setting tracks packets even
            // with thread_count > 1. Non-reference frames are, by
            // definition, inputs to no other frame — dropping the off-grid
            // ones cannot change any emitted pixel.
            bool grid = true;  // unknown pts: decode to be safe
            if (pkt->pts != AV_NOPTS_VALUE) {
              const long long idx = pts_to_index(pkt->pts);
              grid = idx >= skip_first && (idx % skip_step) == 0;
            }
            ctx->skip_frame = grid ? AVDISCARD_DEFAULT : AVDISCARD_NONREF;
          }
          int sr = avcodec_send_packet(ctx, pkt);
          av_packet_unref(pkt);
          if (sr < 0 && sr != AVERROR(EAGAIN)) return false;
          break;
        }
        av_packet_unref(pkt);
      }
    }
  }

  // Luma plane (VR: bottom-left quadrant) -> 256x256 gray. Range-expansion
  // LUT is applied per SOURCE sample, then the cv2-exact fixed-point
  // bilinear resize — the same order as cv2's YUV->BGR(+expand)->resize
  // chain, and bit-identical to cv2.resize(INTER_LINEAR) on the expanded
  // luma plane (sws_scale's bilinear was only close, not equal).
  // Narrow a >8-bit luma region (native-endian uint16 samples) to 8 bits
  // with rounding into depth_buf. Limited range scales with the depth
  // (10-bit 64..940 >> 2 -> 16..235), so the 8-bit expansion LUT stays
  // correct downstream.
  void narrow_region(const uint8_t* src, int stride, int rw, int rh,
                     int depth) {
    depth_buf.resize((size_t)rw * rh);
    const int shift = depth - 8, round = 1 << (shift - 1);
    for (int y = 0; y < rh; y++) {
      const uint16_t* s =
          reinterpret_cast<const uint16_t*>(src + (size_t)y * stride);
      unsigned char* o = depth_buf.data() + (size_t)y * rw;
      for (int x = 0; x < rw; x++) {
        const int v = (s[x] + round) >> shift;
        o[x] = (unsigned char)(v > 255 ? 255 : v);
      }
    }
  }

  // Rotate an 8-bit plane clockwise by ``rot`` degrees into rot_buf,
  // updating w/h to the display orientation.
  void rotate_plane(const unsigned char* src, int stride, int& w, int& h) {
    rot_buf.resize((size_t)w * h);
    if (rot == 180) {
      for (int i = 0; i < h; i++) {
        const unsigned char* s = src + (size_t)(h - 1 - i) * stride;
        unsigned char* o = rot_buf.data() + (size_t)i * w;
        for (int j = 0; j < w; j++) o[j] = s[w - 1 - j];
      }
      return;
    }
    const int W = w, H = h;  // output: W rows x H cols
    for (int i = 0; i < W; i++) {
      unsigned char* o = rot_buf.data() + (size_t)i * H;
      if (rot == 90) {  // clockwise: dst[i][j] = src[H-1-j][i]
        for (int j = 0; j < H; j++)
          o[j] = src[(size_t)(H - 1 - j) * stride + i];
      } else {  // 270 = counterclockwise: dst[i][j] = src[j][W-1-i]
        for (int j = 0; j < H; j++) o[j] = src[(size_t)j * stride + (W - 1 - i)];
      }
    }
    w = H;
    h = W;
  }

  bool to_gray(unsigned char* out, bool vr_mode) {
    int w = frm->width, h = frm->height;
    if (w <= 0 || h <= 0 || !frm->data[0]) return false;
    const uint8_t* src = frm->data[0];
    int stride = frm->linesize[0];
    const AVPixFmtDescriptor* desc =
        av_pix_fmt_desc_get((AVPixelFormat)frm->format);
    const int depth = desc ? desc->comp[0].depth : 8;
    if (rot != 0) {
      // rotation needs the full plane: narrow it all (if >8-bit), rotate,
      // then crop in display orientation
      if (depth > 8) {
        narrow_region(src, stride, w, h, depth);
        src = depth_buf.data();
        stride = w;
      }
      rotate_plane(src, stride, w, h);
      src = rot_buf.data();
      stride = w;
    }
    int cw = w, ch = h;
    size_t off = 0;
    if (vr_mode) {
      cw = w / 2;
      ch = h - h / 2;
      off = (size_t)(h / 2) * stride;
    }
    if (cw <= 0 || ch <= 0) return false;
    if (rot == 0 && depth > 8) {
      // no rotation: narrow only the cropped region (half the work for VR)
      narrow_region(src + off, stride, cw, ch, depth);
      src = depth_buf.data();
      stride = cw;
      off = 0;
    }
    if (plan.sw != cw || plan.sh != ch) plan.build(cw, ch);
    plan.run(src + off, stride, lut, out);
    return true;
  }
};

// ---------------------------------------------------------------------------
// Pump: one decoder thread (either engine), pooled buffers, bounded queue.
// ---------------------------------------------------------------------------
struct FramePump {
#ifdef FF_PUMP_EXACT
  // EXACT engine
  cv::VideoCapture cap;
#endif
  // FAST engine
  LavDecoder lav;
  bool fast = false;

  double fps = 0.0;
  long long total_frames = 0;
  int src_w = 0, src_h = 0;
  // exact engine: display rotation applied in preprocess (clockwise deg);
  // auto-orientation is disabled on the capture (wrong direction in cv 4.6)
  int exact_rot = 0;
  int step = 1;
  bool vr_mode = false;
  bool gray = false;            // emit 1-channel gray (production path)
  size_t queue_depth = 256;
  long long start_sample = 0;   // first sampled-grid index this pump decodes
  long long max_samples = -1;   // -1 = through end of video

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<std::vector<unsigned char>> queue;
  std::deque<std::vector<unsigned char>> pool;
  std::atomic<bool> done{false};
  std::atomic<bool> cancel{false};

  // Direct-write slab mode (fp_open_v3 + fp_submit_slab/fp_wait_slab): the
  // caller registers destination buffers up front and the decode thread
  // preprocesses STRAIGHT into them — no pooled intermediate frame, no
  // per-frame memcpy in next_batch. Slabs fill strictly in FIFO order.
  struct Slab {
    unsigned char* ptr;
    int capacity;
    int filled = 0;
  };
  bool direct = false;
  std::deque<Slab> slabs;      // guarded by mu; front = oldest
  size_t write_idx = 0;        // index into slabs of the slab being filled

  size_t frame_bytes() const {
    return static_cast<size_t>(kOutSize) * kOutSize * (gray ? 1 : 3);
  }

  // Decode thread: next destination slot, or nullptr on cancel.
  unsigned char* slot_acquire() {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] {
      return cancel.load() || write_idx < slabs.size();
    });
    if (cancel.load()) return nullptr;
    Slab& s = slabs[write_idx];
    return s.ptr + static_cast<size_t>(s.filled) * frame_bytes();
  }

  void slot_commit() {
    std::unique_lock<std::mutex> lk(mu);
    if (write_idx >= slabs.size()) return;  // cancelled/raced close
    Slab& s = slabs[write_idx];
    s.filled++;
    if (s.filled >= s.capacity) {
      write_idx++;
      cv_pop.notify_all();
    }
  }

  void submit_slab(unsigned char* ptr, int capacity) {
    std::unique_lock<std::mutex> lk(mu);
    slabs.push_back(Slab{ptr, capacity});
    cv_push.notify_all();
  }

  // Blocks until the OLDEST slab is complete (or decode done/cancel), pops
  // it, and returns its filled count. -1: no slab outstanding. -2: cancel.
  long long wait_slab() {
    std::unique_lock<std::mutex> lk(mu);
    if (slabs.empty()) return -1;
    cv_pop.wait(lk, [&] {
      return cancel.load() || done.load() ||
             (!slabs.empty() && slabs.front().filled >= slabs.front().capacity);
    });
    if (cancel.load()) return -2;
    if (slabs.empty()) return -1;
    long long n = slabs.front().filled;
    slabs.pop_front();
    if (write_idx > 0) write_idx--;
    return n;
  }

  void run() {
#ifdef FF_PUMP_EXACT
    if (!fast) {
      run_exact();
    } else
#endif
    {
      run_fast();
    }
    done.store(true);
    cv_pop.notify_all();
  }

#ifdef FF_PUMP_EXACT
  void run_exact() {
    cv::Mat bgr;
    long long pos = start_sample * step;
    long long n_samples = sample_budget();
    long long emitted = 0;
    while (!cancel.load() && emitted < n_samples) {
      if (!cap.grab()) break;  // container shorter than advertised: clean EOF
      if (pos % step == 0) {
        if (direct) {
          unsigned char* out = slot_acquire();
          if (!out) break;  // cancelled
          bool ok = cap.retrieve(bgr);
          if (ok && !bgr.empty()) {
            preprocess(bgr, out);
          } else {
            std::memset(out, 0, frame_bytes());  // black frame on failure
          }
          slot_commit();
        } else {
          std::vector<unsigned char> buf = take_buffer();
          bool ok = cap.retrieve(bgr);
          if (ok && !bgr.empty()) {
            preprocess(bgr, buf.data());
          } else {
            std::memset(buf.data(), 0, frame_bytes());  // black frame on failure
          }
          push(std::move(buf));
        }
        emitted++;
      }
      pos++;
    }
  }
#endif  // FF_PUMP_EXACT

  void run_fast() {
    long long n_samples = sample_budget();
    long long emitted = 0;
    // Sampling is by TIME slot: slot k wants the frame at presentation
    // index k*step, and each decoded frame fills every not-yet-filled slot
    // at or before its index (presentation order is monotonic, so the
    // first frame with idx >= slot is the nearest-at-or-after candidate).
    // On CFR content this is exactly "emit frames whose idx is on the
    // grid". On VFR content it keeps array position == time slot: a
    // timestamp gap holds the next frame for the missed slots and jitter
    // collapsing two frames onto one slot drops the later one — the
    // alternative (emit-by-decode-count, what cv2/the reference do) makes
    // every action after a camera stall drift by the stalled duration.
    long long next_grid = start_sample * step;
    while (!cancel.load() && emitted < n_samples) {
      if (!lav.next_frame()) break;  // clean EOF
      const long long idx = lav.frame_idx;
      if (idx < next_grid) continue;  // seek pre-roll / slot already filled
      bool stop = false;
      while (!stop && !cancel.load() && emitted < n_samples &&
             next_grid <= idx) {
        if (direct) {
          unsigned char* out = slot_acquire();
          if (!out) { stop = true; break; }  // cancelled
          if (!lav.to_gray(out, vr_mode)) {
            std::memset(out, 0, frame_bytes());  // black frame on failure
          }
          slot_commit();
        } else {
          std::vector<unsigned char> buf = take_buffer();
          if (!lav.to_gray(buf.data(), vr_mode)) {
            std::memset(buf.data(), 0, frame_bytes());  // black frame on failure
          }
          push(std::move(buf));
        }
        emitted++;
        next_grid += step;
      }
      if (stop) break;
    }
  }

  long long sample_budget() const {
    long long n_total = (total_frames + step - 1) / step;
    long long n = n_total - start_sample;
    if (max_samples >= 0 && max_samples < n) n = max_samples;
    return n < 0 ? 0 : n;
  }

#ifdef FF_PUMP_EXACT
  void preprocess(cv::Mat bgr, unsigned char* out) {
    if (exact_rot) {  // display rotation, clockwise-degrees convention
      cv::Mat rotated;
      cv::rotate(bgr, rotated,
                 exact_rot == 90    ? cv::ROTATE_90_CLOCKWISE
                 : exact_rot == 180 ? cv::ROTATE_180
                                    : cv::ROTATE_90_COUNTERCLOCKWISE);
      bgr = rotated;
    }
    // gray output = cv2 BGR2GRAY (BT.601 fixed point), bit-identical to the
    // on-device rgb_to_gray_cv — the production path ships 1/3 the bytes
    cv::Mat dst(kOutSize, kOutSize, gray ? CV_8UC1 : CV_8UC3, out);
    const int code = gray ? cv::COLOR_BGR2GRAY : cv::COLOR_BGR2RGB;
    if (vr_mode) {
      cv::Mat r512;
      cv::resize(bgr, r512, cv::Size(kVrSize, kVrSize), 0, 0, cv::INTER_LINEAR);
      cv::Mat crop = r512(cv::Rect(0, kVrSize / 2, kVrSize / 2, kVrSize / 2));
      cv::cvtColor(crop, dst, code);
    } else {
      cv::Mat r256;
      cv::resize(bgr, r256, cv::Size(kOutSize, kOutSize), 0, 0, cv::INTER_LINEAR);
      cv::cvtColor(r256, dst, code);
    }
  }
#endif  // FF_PUMP_EXACT

  std::vector<unsigned char> take_buffer() {
    std::unique_lock<std::mutex> lk(mu);
    if (!pool.empty()) {
      auto b = std::move(pool.front());
      pool.pop_front();
      return b;
    }
    return std::vector<unsigned char>(frame_bytes());
  }

  void push(std::vector<unsigned char> buf) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return queue.size() < queue_depth || cancel.load(); });
    if (cancel.load()) return;
    queue.push_back(std::move(buf));
    cv_pop.notify_one();
  }

  // Returns frames copied (0 => EOF).
  int next_batch(unsigned char* out, int max_frames) {
    int n = 0;
    std::unique_lock<std::mutex> lk(mu);
    while (n < max_frames) {
      cv_pop.wait(lk, [&] { return !queue.empty() || done.load() || cancel.load(); });
      if (cancel.load()) return n;
      if (queue.empty()) break;  // done && drained
      auto buf = std::move(queue.front());
      queue.pop_front();
      std::memcpy(out + static_cast<size_t>(n) * frame_bytes(), buf.data(), frame_bytes());
      pool.push_back(std::move(buf));
      cv_push.notify_one();
      n++;
    }
    return n;
  }
};

}  // namespace

extern "C" {

namespace {

FramePump* fp_open_impl(const char* path, int vr_mode, int step,
                        int queue_depth, long long start_sample,
                        long long max_samples, int gray, int fast,
                        int direct) {
  auto* p = new FramePump();
  p->direct = direct != 0;  // set BEFORE the worker thread starts
  p->step = step;  // <= 0: self-probe from fps at open
  p->vr_mode = vr_mode != 0;
  p->queue_depth = queue_depth > 0 ? static_cast<size_t>(queue_depth) : 256;
  p->start_sample = start_sample > 0 ? start_sample : 0;
  p->max_samples = max_samples;
  p->gray = gray != 0;

  g_last_error.clear();
  if (fast && p->gray) {
    av_log_set_level(AV_LOG_ERROR);
    if (p->lav.open(path, p->vr_mode)) {
      p->fps = p->lav.fps;
      if (p->step <= 0) {  // self-probe: step = ceil(fps/30), one open total
        p->step = (int)std::max(1.0, std::ceil(p->fps / 30.0));
      }
      p->lav.skip_step = p->step;  // off-grid non-ref frames: skip decode
      p->lav.skip_first = p->start_sample * (long long)p->step;
      if (p->start_sample == 0 || p->lav.seek_to(p->start_sample * p->step)) {
        p->fast = true;
        p->total_frames = p->lav.total_frames;
        p->src_w = p->lav.src_w;
        p->src_h = p->lav.src_h;
        p->worker = std::thread([p] { p->run(); });
        return p;
      }
      p->lav.why = "the frame-accurate seek failed";
    }
    p->lav.close();  // fall back to the exact engine
  }

#ifdef FF_PUMP_EXACT
  if (!p->cap.open(path)) {
    g_last_error = std::string("OpenCV cannot open ") + path;
    delete p;
    return nullptr;
  }
  // Display-matrix rotation: system OpenCV 4.6 auto-rotates 90/270 the
  // WRONG way (fixed upstream in 4.7, opencv#21946), and its
  // CAP_PROP_ORIENTATION_META uses the opposite angle convention from 5.x
  // (measured: 270 vs 90 for the same file) — so neither auto mode nor the
  // META property is trustworthy across versions. Read the display matrix
  // through libav (stable convention), disable auto-orientation, and
  // rotate in preprocess() ourselves, matching cv2 >= 4.7 / every player /
  // the fast engine.
  p->exact_rot = display_rotation_cw(path);
  p->cap.set(cv::CAP_PROP_ORIENTATION_AUTO, 0.0);
  p->fps = p->cap.get(cv::CAP_PROP_FPS);
  p->total_frames = static_cast<long long>(p->cap.get(cv::CAP_PROP_FRAME_COUNT));
  p->src_w = static_cast<int>(p->cap.get(cv::CAP_PROP_FRAME_WIDTH));
  p->src_h = static_cast<int>(p->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
  if (p->exact_rot == 90 || p->exact_rot == 270) std::swap(p->src_w, p->src_h);
  if (p->step <= 0) {  // self-probe (same formula as VideoMeta.step)
    p->step = (int)std::max(1.0, std::ceil(p->fps / 30.0));
  }
  if (p->start_sample > 0) {
    p->cap.set(cv::CAP_PROP_POS_FRAMES,
               static_cast<double>(p->start_sample * p->step));
  }
  p->worker = std::thread([p] { p->run(); });
  return p;
#else
  // no exact engine to fall back to: fail the open, saying why
  if (fast && p->gray) {
    g_last_error = "fast engine: " + p->lav.why +
                   " (no exact engine: built without OpenCV)";
  } else {
    g_last_error = "the exact engine is not built (no OpenCV headers); "
                   "this build decodes only gray frames with fast=1";
  }
  delete p;
  return nullptr;
#endif
}

}  // namespace

// v2: ``fast`` selects the libav fast engine (lowres + gray-only decode) —
// best-effort: falls back to the exact OpenCV engine when the codec or
// container rejects it. Fast mode implies gray output.
void* fp_open_v2(const char* path, int vr_mode, int step, int queue_depth,
                 long long start_sample, long long max_samples, int gray,
                 int fast) {
  return fp_open_impl(path, vr_mode, step, queue_depth, start_sample,
                      max_samples, gray, fast, 0);
}

// v3: ``direct`` enables direct-write slab mode — the caller must then feed
// destination buffers via fp_submit_slab and collect them with fp_wait_slab
// (fp_next_batch is not used). The decode thread blocks until a slab is
// available, so submit one promptly after open.
void* fp_open_v3(const char* path, int vr_mode, int step, int queue_depth,
                 long long start_sample, long long max_samples, int gray,
                 int fast, int direct) {
  return fp_open_impl(path, vr_mode, step, queue_depth, start_sample,
                      max_samples, gray, fast, direct);
}

// Register one destination slab of ``capacity`` frames (caller-owned memory,
// frame_bytes() per frame). FIFO fill order.
int fp_submit_slab(void* h, unsigned char* ptr, int capacity) {
  auto* p = static_cast<FramePump*>(h);
  if (!p->direct || capacity <= 0) return 0;
  p->submit_slab(ptr, capacity);
  return 1;
}

// Block until the oldest slab is full (or EOF/cancel); pops it and returns
// its filled frame count. -1: no slab outstanding; -2: cancelled.
long long fp_wait_slab(void* h) {
  return static_cast<FramePump*>(h)->wait_slab();
}

// Range variant: decode ``max_samples`` sampled-grid frames starting at
// sampled index ``start_sample`` (one frame-accurate seek, then sequential).
// Powers host-parallel decode: N pumps over disjoint contiguous ranges.
void* fp_open_range(const char* path, int vr_mode, int step, int queue_depth,
                    long long start_sample, long long max_samples, int gray) {
  return fp_open_v2(path, vr_mode, step, queue_depth, start_sample,
                    max_samples, gray, 0);
}

void* fp_open(const char* path, int vr_mode, int step, int queue_depth) {
  return fp_open_v2(path, vr_mode, step, queue_depth, 0, -1, 0, 0);
}

// 1 when this build holds the exact (OpenCV) engine, else 0.
int fp_has_exact(void) {
#ifdef FF_PUMP_EXACT
  return 1;
#else
  return 0;
#endif
}

// Why the calling thread's last fp_open* returned nullptr ("" if it did not).
const char* fp_last_error(void) { return g_last_error.c_str(); }

// Reports which engine a pump actually runs (1 = fast/libav, 0 = exact).
int fp_is_fast(void* h) {
  return static_cast<FramePump*>(h)->fast ? 1 : 0;
}

void fp_meta(void* h, double* fps, long long* total_frames, int* w, int* hgt) {
  auto* p = static_cast<FramePump*>(h);
  if (fps) *fps = p->fps;
  if (total_frames) *total_frames = p->total_frames;
  if (w) *w = p->src_w;
  if (hgt) *hgt = p->src_h;
}

int fp_step(void* h) { return static_cast<int>(static_cast<FramePump*>(h)->step); }

int fp_next_batch(void* h, unsigned char* out, int max_frames) {
  return static_cast<FramePump*>(h)->next_batch(out, max_frames);
}

void fp_cancel(void* h) {
  auto* p = static_cast<FramePump*>(h);
  p->cancel.store(true);
  p->cv_push.notify_all();
  p->cv_pop.notify_all();
}

void fp_close(void* h) {
  auto* p = static_cast<FramePump*>(h);
  p->cancel.store(true);
  p->cv_push.notify_all();
  p->cv_pop.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
