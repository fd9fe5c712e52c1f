// Native video encoder — h264 (libx264) fixture/bench-clip generation.
//
// The TPU framework's real workload is long-GOP h264 content (the
// reference's decode hot spot, FunscriptFlow.pyw:177-189), but the OpenCV
// build on TPU hosts ships no h264 encoder, so neither the benchmark nor
// the test suite could produce a representative clip. This tiny encoder
// wraps the system libavcodec's libx264 (falling back to mpeg4) behind a
// C ABI so bench.py and tests generate h264 fixtures natively:
//
//   fe_open(path, w, h, fps_num, fps_den, codec, gop, bframes)
//   fe_write(handle, bgr24_frame)   // one frame, BGR24 row-major
//   fe_close(handle)                // flush + trailer; returns frames written
//
// Encoding quality knobs are fixed at "representative content" settings
// (x264 veryfast, CRF 23) — this is test/bench infrastructure, not a
// production export path.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/display.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <cstdio>
#include <cstring>

namespace {

struct Encoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  AVStream* st = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frm = nullptr;
  AVPacket* pkt = nullptr;
  int w = 0, h = 0;
  long long n_in = 0;
  bool header_written = false;

  ~Encoder() { release(); }

  void release() {
    if (sws) { sws_freeContext(sws); sws = nullptr; }
    if (frm) av_frame_free(&frm);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) {
      if (fmt->pb) avio_closep(&fmt->pb);
      avformat_free_context(fmt);
      fmt = nullptr;
    }
  }

  bool drain_packets() {
    while (true) {
      int r = avcodec_receive_packet(ctx, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
      if (r < 0) return false;
      // One frame per packet: without an explicit duration the mp4 muxer
      // leaves the last frame out of the track duration, and probes then
      // report fps * n/(n-1) (e.g. 30.1 for a 300-frame 30 fps clip) —
      // enough to flip step=ceil(fps/30) from 1 to 2.
      if (pkt->duration == 0) pkt->duration = 1;
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
    }
  }

  bool open(const char* path, int width, int height, int fps_num, int fps_den,
            const char* codec_name, int gop, int bframes,
            const char* pix_fmt_name, int rotation_deg, bool interlaced) {
    w = width;
    h = height;
    if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0)
      return false;
    const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) return false;
    // pixel format: default 8-bit 4:2:0; callers may request e.g.
    // yuv420p10le for 10-bit fixtures (modern hevc/h264 libraries) — the
    // request must be one the encoder itself supports, or open fails
    // cleanly rather than silently re-converting
    AVPixelFormat pf = AV_PIX_FMT_YUV420P;
    if (pix_fmt_name && pix_fmt_name[0]) {
      pf = av_get_pix_fmt(pix_fmt_name);
      if (pf == AV_PIX_FMT_NONE) return false;
      bool ok = false;
      if (codec->pix_fmts)
        for (const AVPixelFormat* p = codec->pix_fmts; *p != AV_PIX_FMT_NONE;
             p++)
          ok |= (*p == pf);
      if (!ok) return false;
    }
    st = avformat_new_stream(fmt, nullptr);
    ctx = avcodec_alloc_context3(codec);
    if (!st || !ctx) return false;
    ctx->width = w;
    ctx->height = h;
    ctx->time_base = AVRational{fps_den, fps_num};
    ctx->framerate = AVRational{fps_num, fps_den};
    ctx->pix_fmt = pf;
    ctx->gop_size = gop > 0 ? gop : 250;
    ctx->max_b_frames = bframes >= 0 ? bframes : 3;
    if (std::strcmp(codec_name, "libx264") == 0) {
      av_opt_set(ctx->priv_data, "preset", "veryfast", 0);
      av_opt_set(ctx->priv_data, "crf", "23", 0);
    } else if (std::strcmp(codec_name, "libx265") == 0) {
      // hevc fixtures (the dominant VR-library codec): fast settings and
      // quiet logs — x265's banner goes to stderr on every open otherwise
      av_opt_set(ctx->priv_data, "preset", "ultrafast", 0);
      av_opt_set(ctx->priv_data, "crf", "23", 0);
      av_opt_set(ctx->priv_data, "x265-params", "log-level=none", 0);
    } else if (std::strcmp(codec_name, "libvpx-vp9") == 0) {
      // .webm fixtures (reference extension whitelist includes .webm,
      // FunscriptFlow.pyw:28-29): realtime deadline or encode is ~10 fps
      av_opt_set(ctx->priv_data, "deadline", "realtime", 0);
      av_opt_set(ctx->priv_data, "cpu-used", "8", 0);
      av_opt_set(ctx->priv_data, "crf", "30", 0);
      ctx->bit_rate = 0;  // crf-only rate control
    } else if (std::strcmp(codec_name, "libaom-av1") == 0) {
      av_opt_set(ctx->priv_data, "usage", "realtime", 0);
      av_opt_set(ctx->priv_data, "cpu-used", "8", 0);
      av_opt_set(ctx->priv_data, "crf", "30", 0);
      ctx->bit_rate = 0;
    } else if (std::strcmp(codec_name, "mpeg2video") == 0 ||
               std::strcmp(codec_name, "mpeg1video") == 0) {
      // .mpg/.ts fixtures: the MPEG-PS muxer models a CBR channel; without
      // encoder rate control it logs a "buffer underflow" per GOP. DVD-ish
      // VBV settings keep the program stream well-formed.
      ctx->bit_rate = 6000000;
      ctx->rc_max_rate = 6000000;
      ctx->rc_buffer_size = 1835008;
    }
    if (interlaced) {
      // x264 MBAFF / mpeg2 interlaced DCT + motion estimation (1080i-era
      // content); top-field-first like broadcast material
      ctx->flags |= AV_CODEC_FLAG_INTERLACED_DCT | AV_CODEC_FLAG_INTERLACED_ME;
      ctx->field_order = AV_FIELD_TT;
    }
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(ctx, codec, nullptr) < 0) return false;
    if (avcodec_parameters_from_context(st->codecpar, ctx) < 0) return false;
    st->time_base = ctx->time_base;
    // Matroska stores timestamps in milliseconds; without the stream frame
    // rate the muxer writes no DefaultDuration and a 30 fps clip probes as
    // 1000/33 = 30.3 fps with an off-by-one frame count (enough to flip
    // step=ceil(fps/30) to 2). Real-world muxers set it; so do we.
    st->avg_frame_rate = ctx->framerate;
    // Rotation metadata (phone-recorded content): a display matrix on the
    // stream, exactly as mobile muxers write it. Must precede the header.
    if (rotation_deg) {
      uint8_t* sd = av_stream_new_side_data(st, AV_PKT_DATA_DISPLAYMATRIX,
                                            9 * sizeof(int32_t));
      if (!sd) return false;
      av_display_rotation_set(reinterpret_cast<int32_t*>(sd), rotation_deg);
    }
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
      return false;
    if (avformat_write_header(fmt, nullptr) < 0) return false;
    header_written = true;
    frm = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frm || !pkt) return false;
    frm->format = pf;
    frm->width = w;
    frm->height = h;
    if (av_frame_get_buffer(frm, 0) < 0) return false;
    sws = sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h, pf,
                         SWS_BILINEAR, nullptr, nullptr, nullptr);
    return sws != nullptr;
  }

  // pts < 0: CFR, frame index in time_base ticks. pts >= 0: explicit
  // timestamp (VFR fixtures — real phone/stream captures drop frames and
  // jitter timestamps; tests need representative content).
  bool write(const unsigned char* bgr, long long pts) {
    if (av_frame_make_writable(frm) < 0) return false;
    const uint8_t* src[4] = {bgr, nullptr, nullptr, nullptr};
    int src_ls[4] = {3 * w, 0, 0, 0};
    sws_scale(sws, src, src_ls, 0, h, frm->data, frm->linesize);
    frm->pts = pts >= 0 ? pts : n_in;
    n_in++;
    if (avcodec_send_frame(ctx, frm) < 0) return false;
    return drain_packets();
  }

  long long close_file() {
    long long n = n_in;
    if (ctx && header_written) {
      avcodec_send_frame(ctx, nullptr);  // flush
      drain_packets();
      av_write_trailer(fmt);
    }
    release();
    return n;
  }
};

}  // namespace

extern "C" {

// Returns a handle, or null. codec: "libx264" | "mpeg4" | any libavcodec
// encoder name. gop <= 0 -> 250 (long GOP); bframes < 0 -> 3. pix_fmt:
// libav pixel format name ("yuv420p10le", ...); null/"" -> yuv420p.
// rot_deg: display-matrix rotation metadata in degrees (0 = none). Positive
// rot_deg yields CLOCKWISE display rotation (the mp4 rotate-tag convention
// players and cv2 5.0 follow, and what phone muxers write for portrait) —
// note av_display_rotation_set/_get have asymmetric sign conventions, so
// this matches the *effective* behavior tested by
// test_rotated_marker_direction, not the ffmpeg setter's doc string.
void* fe_open_rot(const char* path, int w, int h, int fps_num, int fps_den,
                  const char* codec, int gop, int bframes,
                  const char* pix_fmt, int rot_deg) {
  av_log_set_level(AV_LOG_ERROR);
  auto* e = new Encoder();
  if (!e->open(path, w, h, fps_num, fps_den, codec, gop, bframes, pix_fmt,
               rot_deg, false)) {
    delete e;
    return nullptr;
  }
  return e;
}

// Interlaced encode (x264 MBAFF / MPEG-2 interlaced DCT) — 1080i-era
// broadcast/library content for decode-parity fixtures.
void* fe_open_ilace(const char* path, int w, int h, int fps_num, int fps_den,
                    const char* codec, int gop, int bframes,
                    const char* pix_fmt, int rot_deg) {
  av_log_set_level(AV_LOG_ERROR);
  auto* e = new Encoder();
  if (!e->open(path, w, h, fps_num, fps_den, codec, gop, bframes, pix_fmt,
               rot_deg, true)) {
    delete e;
    return nullptr;
  }
  return e;
}

void* fe_open_fmt(const char* path, int w, int h, int fps_num, int fps_den,
                  const char* codec, int gop, int bframes,
                  const char* pix_fmt) {
  return fe_open_rot(path, w, h, fps_num, fps_den, codec, gop, bframes,
                     pix_fmt, 0);
}

void* fe_open(const char* path, int w, int h, int fps_num, int fps_den,
              const char* codec, int gop, int bframes) {
  return fe_open_rot(path, w, h, fps_num, fps_den, codec, gop, bframes,
                     nullptr, 0);
}

// One BGR24 frame (h rows of 3*w bytes). Returns 1 on success.
int fe_write(void* handle, const unsigned char* bgr) {
  return static_cast<Encoder*>(handle)->write(bgr, -1) ? 1 : 0;
}

// Same, with an explicit pts in stream time-base ticks (1/fps units) —
// for VFR fixtures. pts must be strictly increasing across calls.
int fe_write_at(void* handle, const unsigned char* bgr, long long pts) {
  return static_cast<Encoder*>(handle)->write(bgr, pts) ? 1 : 0;
}

// Remux ``src`` into ``dst`` adding ``jpeg`` as an attached-picture stream
// (cover art) — the real-world stream-selection trap: music-video/library
// files carry an embedded thumbnail as a second, often higher-resolution,
// video stream with AV_DISPOSITION_ATTACHED_PIC that decoders must NOT
// pick as the content. Returns 1 on success. dst container must support
// attachments (mkv does; mp4 maps to covr).
int fe_add_cover(const char* src_path, const char* dst_path,
                 const char* jpeg_path, int cover_w, int cover_h) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* in = nullptr;
  AVFormatContext* out = nullptr;
  uint8_t* jpeg = nullptr;
  size_t jpeg_size = 0;
  int ret = 0;
  AVPacket* pkt = av_packet_alloc();
  do {
    if (!pkt) break;
    // slurp the jpeg
    FILE* jf = std::fopen(jpeg_path, "rb");
    if (!jf) break;
    std::fseek(jf, 0, SEEK_END);
    long sz = std::ftell(jf);
    std::fseek(jf, 0, SEEK_SET);
    jpeg = (uint8_t*)av_malloc(sz + AV_INPUT_BUFFER_PADDING_SIZE);
    if (!jpeg || std::fread(jpeg, 1, sz, jf) != (size_t)sz) {
      std::fclose(jf);
      break;
    }
    std::fclose(jf);
    jpeg_size = (size_t)sz;

    if (avformat_open_input(&in, src_path, nullptr, nullptr) < 0) break;
    if (avformat_find_stream_info(in, nullptr) < 0) break;
    if (avformat_alloc_output_context2(&out, nullptr, nullptr, dst_path) < 0)
      break;
    bool ok = true;
    for (unsigned i = 0; i < in->nb_streams; i++) {
      AVStream* os = avformat_new_stream(out, nullptr);
      if (!os ||
          avcodec_parameters_copy(os->codecpar, in->streams[i]->codecpar) < 0) {
        ok = false;
        break;
      }
      os->time_base = in->streams[i]->time_base;
      os->avg_frame_rate = in->streams[i]->avg_frame_rate;
    }
    if (!ok) break;
    AVStream* cs = avformat_new_stream(out, nullptr);
    if (!cs) break;
    cs->codecpar->codec_type = AVMEDIA_TYPE_VIDEO;
    cs->codecpar->codec_id = AV_CODEC_ID_MJPEG;
    cs->codecpar->width = cover_w;
    cs->codecpar->height = cover_h;
    cs->disposition = AV_DISPOSITION_ATTACHED_PIC;
    cs->time_base = AVRational{1, 90000};
    if (!(out->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&out->pb, dst_path, AVIO_FLAG_WRITE) < 0)
      break;
    if (avformat_write_header(out, nullptr) < 0) break;
    // the cover packet first (demuxers surface it at any position)
    if (av_new_packet(pkt, (int)jpeg_size) < 0) break;
    std::memcpy(pkt->data, jpeg, jpeg_size);
    pkt->stream_index = cs->index;
    pkt->pts = pkt->dts = 0;
    pkt->flags |= AV_PKT_FLAG_KEY;
    if (av_interleaved_write_frame(out, pkt) < 0) break;
    while (av_read_frame(in, pkt) >= 0) {
      const int si = pkt->stream_index;
      av_packet_rescale_ts(pkt, in->streams[si]->time_base,
                           out->streams[si]->time_base);
      if (av_interleaved_write_frame(out, pkt) < 0) {
        ok = false;
        break;
      }
    }
    if (!ok) break;
    if (av_write_trailer(out) < 0) break;
    ret = 1;
  } while (false);
  if (pkt) av_packet_free(&pkt);
  if (jpeg) av_free(jpeg);
  if (in) avformat_close_input(&in);
  if (out) {
    if (out->pb) avio_closep(&out->pb);
    avformat_free_context(out);
  }
  return ret;
}

// Flush, write trailer, free. Returns frames written (<0 on null handle).
long long fe_close(void* handle) {
  auto* e = static_cast<Encoder*>(handle);
  if (!e) return -1;
  long long n = e->close_file();
  delete e;
  return n;
}

}  // extern "C"
