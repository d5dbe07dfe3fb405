// Native data-plane: encoded-video container decoding for the Kinetics
// pipeline (the role PyAV plays in the reference,
// slowfast/datasets/decoder.py:148-233), binding the system libav*
// (ffmpeg 5.x) directly through a small C ABI consumed via ctypes
// (svit_tpu_torch/native/video.py).  The clip-window/temporal-sampling logic
// stays in Python (svit_tpu_torch/data/decoder.py) — this layer only does
// "seek to window, decode frames with pts in [start, end], give me RGB24".
//
// Also exports a tiny mpeg4 test encoder (gray-ramp frames with
// per-frame luma = 16 + 3*i) so the test suite can exercise REAL encoded
// containers end-to-end without shipping binary fixtures.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Decoded {
  int64_t pts;
  uint8_t* rgb;  // h*w*3, malloc'd
};

struct OpenVideo {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_idx = -1;

  ~OpenVideo() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

// Open `path` and set up the video decoder.  Returns 0 on success.
int open_video(const char* path, OpenVideo* v) {
  if (avformat_open_input(&v->fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(v->fmt, nullptr) < 0) return -2;
  const AVCodec* codec = nullptr;
  v->stream_idx =
      av_find_best_stream(v->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (v->stream_idx < 0 || !codec) return -3;
  v->dec = avcodec_alloc_context3(codec);
  if (!v->dec) return -4;
  AVStream* st = v->fmt->streams[v->stream_idx];
  if (avcodec_parameters_to_context(v->dec, st->codecpar) < 0) return -5;
  if (avcodec_open2(v->dec, codec, nullptr) < 0) return -6;
  return 0;
}

}  // namespace

extern "C" {

void svit_video_free(void* p) { free(p); }

// Stream metadata: average fps, container frame count (0 when unknown) and
// stream duration in pts units (-1 when unknown) — exactly the three fields
// the Python windowing logic reads off PyAV
// (svit_tpu_torch/data/decoder.py pyav_decode).
int svit_video_probe(const char* path, double* fps, int64_t* nb_frames,
                     int64_t* duration) {
  OpenVideo v;
  if (int rc = open_video(path, &v)) return rc;
  AVStream* st = v.fmt->streams[v.stream_idx];
  AVRational r = st->avg_frame_rate;
  if (r.num == 0 || r.den == 0) r = av_guess_frame_rate(v.fmt, st, nullptr);
  *fps = (r.den > 0) ? av_q2d(r) : 0.0;
  *nb_frames = st->nb_frames;
  *duration = (st->duration == AV_NOPTS_VALUE) ? -1 : st->duration;
  return 0;
}

// Decode frames whose pts lies in [start_pts, end_pts] (stream time-base
// units) as packed RGB24, ordered by pts.  Seeks to the keyframe at/before
// max(start_pts - 1024, 0) first (PyAV parity: backward=True seek with the
// same offset slack).  end_pts < 0 decodes the whole stream.  Returns a
// malloc'd [n, h, w, 3] buffer (svit_video_free) or null; *pts_out, when
// non-null, receives a malloc'd int64[n] of the frame pts.
uint8_t* svit_video_decode_window(const char* path, int64_t start_pts,
                                  int64_t end_pts, int* n_out, int* w_out,
                                  int* h_out, int64_t** pts_out) {
  *n_out = 0;
  OpenVideo v;
  if (open_video(path, &v)) return nullptr;
  const bool decode_all = end_pts < 0;
  if (!decode_all) {
    int64_t seek = std::max<int64_t>(start_pts - 1024, 0);
    av_seek_frame(v.fmt, v.stream_idx, seek, AVSEEK_FLAG_BACKWARD);
  }

  const int w = v.dec->width, h = v.dec->height;
  if (w <= 0 || h <= 0) return nullptr;
  SwsContext* sws = sws_getContext(w, h, v.dec->pix_fmt, w, h,
                                   AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                                   nullptr, nullptr);
  if (!sws) return nullptr;

  std::vector<Decoded> frames;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  bool done = false, flushed = false;

  auto take = [&](AVFrame* f) {
    int64_t pts = (f->pts == AV_NOPTS_VALUE) ? f->best_effort_timestamp : f->pts;
    if (pts == AV_NOPTS_VALUE) return;          // pyav: skip pts-less frames
    if (!decode_all && pts < start_pts) return;  // before the window
    if (!decode_all && pts > end_pts) {          // past it: stop decoding
      done = true;
      return;
    }
    uint8_t* rgb = static_cast<uint8_t*>(malloc(size_t(h) * w * 3));
    if (!rgb) {
      done = true;
      return;
    }
    uint8_t* dst[1] = {rgb};
    int stride[1] = {w * 3};
    sws_scale(sws, f->data, f->linesize, 0, h, dst, stride);
    frames.push_back({pts, rgb});
  };

  while (!done) {
    int rc = flushed ? AVERROR_EOF : av_read_frame(v.fmt, pkt);
    if (rc >= 0 && pkt->stream_index != v.stream_idx) {
      av_packet_unref(pkt);
      continue;
    }
    if (rc >= 0) {
      avcodec_send_packet(v.dec, pkt);
      av_packet_unref(pkt);
    } else if (!flushed) {
      avcodec_send_packet(v.dec, nullptr);  // drain
      flushed = true;
    } else {
      break;
    }
    while (!done) {
      int r = avcodec_receive_frame(v.dec, frame);
      if (r == AVERROR(EAGAIN)) break;
      if (r < 0) {  // AVERROR_EOF after the drain packet
        done = done || flushed;
        break;
      }
      take(frame);
    }
    if (flushed) break;
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  sws_freeContext(sws);

  std::sort(frames.begin(), frames.end(),
            [](const Decoded& a, const Decoded& b) { return a.pts < b.pts; });
  const int n = static_cast<int>(frames.size());
  uint8_t* out = nullptr;
  if (n > 0) {
    out = static_cast<uint8_t*>(malloc(size_t(n) * h * w * 3));
    int64_t* pts_arr = nullptr;
    if (out && pts_out)
      pts_arr = static_cast<int64_t*>(malloc(sizeof(int64_t) * n));
    if (out) {
      for (int i = 0; i < n; ++i) {
        memcpy(out + size_t(i) * h * w * 3, frames[i].rgb, size_t(h) * w * 3);
        if (pts_arr) pts_arr[i] = frames[i].pts;
      }
      if (pts_out) *pts_out = pts_arr;  // may be null; caller handles it
    }
  }
  for (auto& f : frames) free(f.rgb);
  if (out) {
    *n_out = n;
    *w_out = w;
    *h_out = h;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Streaming RGB24 encoder: the no-OpenCV home of the demo's video writer
// (reference slowfast/visualization/demo_loader.py uses cv2.VideoWriter).
// open -> write(frame)* -> close; mpeg4/yuv420p, muxer from the extension.
// ---------------------------------------------------------------------------

namespace {

struct Encoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* enc = nullptr;
  AVStream* st = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int w = 0, h = 0;
  int64_t next_pts = 0;

  ~Encoder() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (sws) sws_freeContext(sws);
    if (enc) avcodec_free_context(&enc);
    if (fmt) {
      if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
        avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
  }

  // send the current frame (or a null flush) and mux everything available
  int drain(bool flush) {
    if (avcodec_send_frame(enc, flush ? nullptr : frame) < 0) return -7;
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return -8;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return -9;
    }
  }
};

}  // namespace

void* svit_video_encoder_open(const char* path, int w, int h, double fps) {
  if (w <= 1 || h <= 1 || !(fps > 0)) return nullptr;
  auto* e = new Encoder;
  if (avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path) < 0 ||
      !e->fmt) {
    delete e;
    return nullptr;
  }
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  e->st = codec ? avformat_new_stream(e->fmt, nullptr) : nullptr;
  e->enc = codec ? avcodec_alloc_context3(codec) : nullptr;
  if (!e->st || !e->enc) {
    delete e;
    return nullptr;
  }
  // mpeg4 requires even dimensions for 4:2:0 chroma
  e->w = w & ~1;
  e->h = h & ~1;
  e->enc->width = e->w;
  e->enc->height = e->h;
  e->enc->pix_fmt = AV_PIX_FMT_YUV420P;
  // fractional rates (e.g. a probed 14.4 fps source) carry through exactly;
  // cap the denominator at 65535 — mpeg4's time_increment_resolution is a
  // 16-bit field, and av_d2q(fps, 1 << 16) can land exactly one past it,
  // failing avcodec_open2 for pathological probed rates
  e->enc->time_base = av_inv_q(av_d2q(fps, 65535));
  e->enc->gop_size = 12;
  e->enc->max_b_frames = 0;
  // generous bitrate (~1 bit/pixel): the demo overlay must stay legible
  e->enc->bit_rate = int64_t(double(e->w) * e->h * fps);
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(e->enc, codec, nullptr) < 0) {
    delete e;
    return nullptr;
  }
  avcodec_parameters_from_context(e->st->codecpar, e->enc);
  e->st->time_base = e->enc->time_base;
  if (!(e->fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    delete e;
    return nullptr;
  }
  if (avformat_write_header(e->fmt, nullptr) < 0) {
    delete e;
    return nullptr;
  }
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, e->w, e->h,
                          AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr,
                          nullptr);
  e->frame = av_frame_alloc();
  e->pkt = av_packet_alloc();
  if (!e->sws || !e->frame || !e->pkt) {
    delete e;
    return nullptr;
  }
  e->frame->format = e->enc->pix_fmt;
  e->frame->width = e->w;
  e->frame->height = e->h;
  if (av_frame_get_buffer(e->frame, 0) < 0) {
    delete e;
    return nullptr;
  }
  return e;
}

// `rgb` is a packed [h, w, 3] frame at the open() dimensions.
int svit_video_encoder_write(void* handle, const uint8_t* rgb, int w, int h) {
  auto* e = static_cast<Encoder*>(handle);
  if (!e || !rgb || w < e->w || h < e->h) return -1;
  av_frame_make_writable(e->frame);
  const uint8_t* src[1] = {rgb};
  int stride[1] = {w * 3};
  sws_scale(e->sws, src, stride, 0, h, e->frame->data, e->frame->linesize);
  e->frame->pts = e->next_pts++;
  return e->drain(false);
}

// Flush, write the trailer and free the encoder.  Always destroys `handle`.
int svit_video_encoder_close(void* handle) {
  auto* e = static_cast<Encoder*>(handle);
  if (!e) return -1;
  int rc = e->drain(true);
  if (rc == 0 && av_write_trailer(e->fmt) < 0) rc = -10;
  delete e;
  return rc;
}

// Write an mpeg4 container (muxer inferred from the path extension) of `n`
// gray frames with luma 16 + 3*i — a deterministic ramp the tests can
// invert to recover WHICH source frames a decoded clip sampled.
// (Kept separate from the streaming encoder: the ramp writes luma planes
// directly so tests can invert EXACT values; RGB->YUV would round.)
int svit_video_encode_gray_ramp(const char* path, int w, int h, int n,
                                int fps) {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* enc = nullptr;
  // single cleanup path so every early error frees fmt/enc and closes avio
  auto fail = [&](int code) {
    if (enc) avcodec_free_context(&enc);
    if (fmt) {
      if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
        avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
    return code;
  };
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) return fail(-2);
  AVStream* st = avformat_new_stream(fmt, nullptr);
  enc = avcodec_alloc_context3(codec);
  if (!st || !enc) return fail(-3);
  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->time_base = {1, fps};
  enc->gop_size = 12;  // keyframes every 12 frames so window seeks work
  enc->max_b_frames = 0;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) return fail(-4);
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    return fail(-5);
  if (avformat_write_header(fmt, nullptr) < 0) return fail(-6);

  AVFrame* frame = av_frame_alloc();
  frame->format = enc->pix_fmt;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);
  AVPacket* pkt = av_packet_alloc();

  auto drain = [&](bool flush) -> int {
    if (avcodec_send_frame(enc, flush ? nullptr : frame) < 0) return -7;
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return -8;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return -9;
    }
  };

  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i) {
    av_frame_make_writable(frame);
    const uint8_t y = static_cast<uint8_t>(std::min(16 + 3 * i, 235));
    memset(frame->data[0], y, size_t(frame->linesize[0]) * h);
    memset(frame->data[1], 128, size_t(frame->linesize[1]) * (h / 2));
    memset(frame->data[2], 128, size_t(frame->linesize[2]) * (h / 2));
    frame->pts = i;
    rc = drain(false);
  }
  if (rc == 0) rc = drain(true);
  if (rc == 0) av_write_trailer(fmt);

  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&enc);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

}  // extern "C"
