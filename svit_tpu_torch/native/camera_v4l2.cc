// V4L2 webcam capture via raw kernel ioctls — no userspace video library.
//
// Role: the camera source behind the demo's DEMO.WEBCAM path.  The reference
// captures with cv2.VideoCapture(cfg.DEMO.WEBCAM)
// (slowfast/visualization/demo_loader.py:28-47); OpenCV need not be
// installed, and V4L2 is the kernel API cv2 itself sits on, so the shim talks
// to /dev/video* directly: negotiate YUYV (or RGB24), mmap a small ring of
// kernel buffers, stream, and convert YUYV -> RGB on the host (BT.601, the
// same matrix cv2 applies for YUV2RGB_YUY2).
//
// Exposed C ABI (ctypes-bound in svit_tpu_torch/native/camera.py):
//   svit_yuyv_to_rgb(yuyv, w, h, rgb)            — pure conversion (testable)
//   svit_camera_open(dev, req_w, req_h, &w, &h)  — NULL on failure
//   svit_camera_read(cam, rgb)                   — 0 ok, <0 error/timeout
//   svit_camera_close(cam)
//
// Built standalone (make libsvit_camera.so): loads independently of the
// libjpeg / libav shims.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <linux/videodev2.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/select.h>
#include <sys/time.h>
#include <unistd.h>

namespace {

constexpr int kNumBufs = 4;

struct SvitCam {
  int fd = -1;
  int w = 0;
  int h = 0;
  uint32_t fourcc = 0;
  void* bufs[kNumBufs] = {nullptr, nullptr, nullptr, nullptr};
  size_t lens[kNumBufs] = {0, 0, 0, 0};
  int nbuf = 0;
  bool streaming = false;
};

int xioctl(int fd, unsigned long req, void* arg) {
  int r;
  do {
    r = ioctl(fd, req, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}

inline uint8_t clamp8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// ITU-R BT.601 limited-range YUV -> full-range RGB (integer form used by
// cv2 / libswscale for YUYV sources).  Two pixels per macropixel Y0 U Y1 V.
void svit_yuyv_to_rgb(const uint8_t* yuyv, int w, int h, uint8_t* rgb) {
  const int pairs = (w * h) / 2;
  for (int i = 0; i < pairs; ++i) {
    const uint8_t* p = yuyv + i * 4;
    const int d = p[1] - 128;  // U
    const int e = p[3] - 128;  // V
    const int rv = 409 * e + 128;
    const int gv = -100 * d - 208 * e + 128;
    const int bv = 516 * d + 128;
    for (int k = 0; k < 2; ++k) {
      const int c = 298 * (p[2 * k] - 16);
      uint8_t* o = rgb + (i * 2 + k) * 3;
      o[0] = clamp8((c + rv) >> 8);
      o[1] = clamp8((c + gv) >> 8);
      o[2] = clamp8((c + bv) >> 8);
    }
  }
}

void svit_camera_close(void* cam_p) {
  if (cam_p == nullptr) return;
  SvitCam* cam = static_cast<SvitCam*>(cam_p);
  if (cam->fd >= 0) {
    if (cam->streaming) {
      enum v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      xioctl(cam->fd, VIDIOC_STREAMOFF, &type);
    }
    for (int i = 0; i < cam->nbuf; ++i) {
      if (cam->bufs[i] != nullptr && cam->bufs[i] != MAP_FAILED) {
        munmap(cam->bufs[i], cam->lens[i]);
      }
    }
    close(cam->fd);
  }
  delete cam;
}

// Returns an opaque handle, or NULL.  req_w/req_h of 0 ask for 640x480; the
// driver's accepted size comes back in *w / *h (callers size buffers off it).
void* svit_camera_open(const char* dev, int req_w, int req_h,
                       int* w, int* h) {
  SvitCam* cam = new SvitCam();
  cam->fd = open(dev, O_RDWR | O_NONBLOCK);
  if (cam->fd < 0) {
    svit_camera_close(cam);
    return nullptr;
  }

  v4l2_capability cap;
  std::memset(&cap, 0, sizeof(cap));
  if (xioctl(cam->fd, VIDIOC_QUERYCAP, &cap) < 0 ||
      !(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
      !(cap.capabilities & V4L2_CAP_STREAMING)) {
    svit_camera_close(cam);
    return nullptr;
  }

  v4l2_format fmt;
  std::memset(&fmt, 0, sizeof(fmt));
  fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  fmt.fmt.pix.width = req_w > 0 ? req_w : 640;
  fmt.fmt.pix.height = req_h > 0 ? req_h : 480;
  fmt.fmt.pix.pixelformat = V4L2_PIX_FMT_YUYV;
  fmt.fmt.pix.field = V4L2_FIELD_ANY;
  if (xioctl(cam->fd, VIDIOC_S_FMT, &fmt) < 0) {
    svit_camera_close(cam);
    return nullptr;
  }
  // The driver reports what it actually granted; accept YUYV or RGB24.
  cam->fourcc = fmt.fmt.pix.pixelformat;
  if (cam->fourcc != V4L2_PIX_FMT_YUYV &&
      cam->fourcc != V4L2_PIX_FMT_RGB24) {
    svit_camera_close(cam);
    return nullptr;
  }
  cam->w = static_cast<int>(fmt.fmt.pix.width);
  cam->h = static_cast<int>(fmt.fmt.pix.height);
  // The converters below assume packed rows; a driver that pads the row
  // stride would shear every frame.  Reject padded strides outright (rare
  // for YUYV/RGB24 webcams; handling them isn't worth a row loop until a
  // real device needs it).
  const uint32_t packed_bpl =
      static_cast<uint32_t>(cam->w) * (cam->fourcc == V4L2_PIX_FMT_YUYV ? 2 : 3);
  if (fmt.fmt.pix.bytesperline != 0 &&
      fmt.fmt.pix.bytesperline != packed_bpl) {
    svit_camera_close(cam);
    return nullptr;
  }

  v4l2_requestbuffers req;
  std::memset(&req, 0, sizeof(req));
  req.count = kNumBufs;
  req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  req.memory = V4L2_MEMORY_MMAP;
  if (xioctl(cam->fd, VIDIOC_REQBUFS, &req) < 0 || req.count < 2) {
    svit_camera_close(cam);
    return nullptr;
  }
  cam->nbuf = static_cast<int>(req.count) < kNumBufs
                  ? static_cast<int>(req.count)
                  : kNumBufs;
  for (int i = 0; i < cam->nbuf; ++i) {
    v4l2_buffer buf;
    std::memset(&buf, 0, sizeof(buf));
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = i;
    if (xioctl(cam->fd, VIDIOC_QUERYBUF, &buf) < 0) {
      svit_camera_close(cam);
      return nullptr;
    }
    cam->lens[i] = buf.length;
    cam->bufs[i] = mmap(nullptr, buf.length, PROT_READ | PROT_WRITE,
                        MAP_SHARED, cam->fd, buf.m.offset);
    if (cam->bufs[i] == MAP_FAILED) {
      svit_camera_close(cam);
      return nullptr;
    }
    if (xioctl(cam->fd, VIDIOC_QBUF, &buf) < 0) {
      svit_camera_close(cam);
      return nullptr;
    }
  }

  enum v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(cam->fd, VIDIOC_STREAMON, &type) < 0) {
    svit_camera_close(cam);
    return nullptr;
  }
  cam->streaming = true;
  if (w != nullptr) *w = cam->w;
  if (h != nullptr) *h = cam->h;
  return cam;
}

// Blocks (select, 2s timeout) for the next frame and writes w*h*3 RGB bytes.
// Returns 0 on success, -1 on timeout, -2 on device error.
int svit_camera_read(void* cam_p, uint8_t* rgb) {
  if (cam_p == nullptr) return -2;
  SvitCam* cam = static_cast<SvitCam*>(cam_p);

  fd_set fds;
  FD_ZERO(&fds);
  FD_SET(cam->fd, &fds);
  timeval tv;
  tv.tv_sec = 2;
  tv.tv_usec = 0;
  int r;
  do {
    r = select(cam->fd + 1, &fds, nullptr, nullptr, &tv);
  } while (r == -1 && errno == EINTR);
  if (r == 0) return -1;
  if (r < 0) return -2;

  v4l2_buffer buf;
  std::memset(&buf, 0, sizeof(buf));
  buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  buf.memory = V4L2_MEMORY_MMAP;
  if (xioctl(cam->fd, VIDIOC_DQBUF, &buf) < 0) return -2;
  if (buf.index >= static_cast<unsigned>(cam->nbuf)) {
    // out-of-range index from a misbehaving driver: nothing was written
    // into `rgb` — this must be an error, not a "valid" garbage frame
    xioctl(cam->fd, VIDIOC_QBUF, &buf);
    return -2;
  }
  const uint8_t* src = static_cast<const uint8_t*>(cam->bufs[buf.index]);
  if (cam->fourcc == V4L2_PIX_FMT_YUYV) {
    svit_yuyv_to_rgb(src, cam->w, cam->h, rgb);
  } else {  // RGB24: straight copy
    std::memcpy(rgb, src, static_cast<size_t>(cam->w) * cam->h * 3);
  }
  xioctl(cam->fd, VIDIOC_QBUF, &buf);
  return 0;
}

}  // extern "C"
