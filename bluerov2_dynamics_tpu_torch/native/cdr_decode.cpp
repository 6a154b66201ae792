// Batch CDR decoders for rosbag2 ingestion (host-side native path).
//
// The Python sqlite/CDR reader (data/bag_sqlite.py) decodes messages one
// at a time in Python — the only real host-side hot loop in the pipeline
// (~1e5 msgs for a tank recording).  These batch decoders process all
// blobs of a topic in one C call over a concatenated buffer.
//
// CDR (XCDR1, little-endian): 4-byte encapsulation header, then primitives
// aligned to their own size relative to the payload start.  Layouts match
// data/cdr.py (parity-tested in tests/test_torch_cdr.py).
//
// Build: g++ -O2 -shared -fPIC -o libcdrdecode.so cdr_decode.cpp
// (done on demand by data/native_cdr.py into build/native_cdr/, named by a
// hash of this source; bound via ctypes).  The port's own copy of
// bluerov2_dynamics_tpu/native/cdr_decode.cpp.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

struct Reader {
  const uint8_t* buf;
  size_t len;
  size_t pos;  // absolute position; payload starts at 4

  bool ok(size_t need) const { return pos + need <= len; }

  void align(size_t size) {
    size_t rel = pos - 4;
    size_t pad = (size - (rel % size)) % size;
    pos += pad;
  }

  template <typename T>
  bool prim(T* out) {
    align(sizeof(T));
    if (!ok(sizeof(T))) return false;
    std::memcpy(out, buf + pos, sizeof(T));
    pos += sizeof(T);
    return true;
  }

  template <typename T>
  bool array(T* out, size_t n) {
    align(sizeof(T));
    if (!ok(sizeof(T) * n)) return false;
    std::memcpy(out, buf + pos, sizeof(T) * n);
    pos += sizeof(T) * n;
    return true;
  }

  // Skip a CDR string; optionally report whether it contains "base" or
  // "body" (the child-frame heuristic of the reference pipeline).
  bool skip_string(int8_t* body_flag) {
    uint32_t n = 0;
    if (!prim(&n)) return false;
    if (!ok(n)) return false;
    if (body_flag != nullptr) {
      *body_flag = 0;
      const char* s = reinterpret_cast<const char*>(buf + pos);
      for (size_t i = 0; n >= 4 && i + 4 <= n; ++i) {
        if (std::memcmp(s + i, "base", 4) == 0 ||
            std::memcmp(s + i, "body", 4) == 0) {
          *body_flag = 1;
          break;
        }
      }
    }
    pos += n;
    return true;
  }
};

bool check_header(const uint8_t* p, size_t len) {
  return len >= 4 && p[0] == 0x00 && p[1] == 0x01;  // CDR_LE
}

}  // namespace

extern "C" {

// nav_msgs/msg/Odometry -> out rows of 13 doubles:
// [pos(3), quat xyzw(4), lin(3), ang(3)]; body_flags[i] = 1 if the
// child_frame_id contains "base"/"body".  Returns the number of rows
// decoded successfully (stops at the first malformed blob).
int64_t decode_odometry_batch(const uint8_t* data, const int64_t* offsets,
                              int64_t n, double* out, int8_t* body_flags) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* blob = data + offsets[i];
    size_t blen = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    if (!check_header(blob, blen)) return i;
    Reader r{blob, blen, 4};
    int32_t sec;
    uint32_t nsec;
    if (!r.prim(&sec) || !r.prim(&nsec)) return i;
    if (!r.skip_string(nullptr)) return i;            // header.frame_id
    if (!r.skip_string(&body_flags[i])) return i;     // child_frame_id
    double* row = out + i * 13;
    if (!r.array(row, 7)) return i;                   // pose: pos3 + quat4
    r.align(8);
    r.pos += 36 * 8;                                  // pose covariance
    if (!r.array(row + 7, 6)) return i;               // twist: lin3 + ang3
    // trailing twist covariance ignored
  }
  return n;
}

// px4_msgs/msg/ActuatorMotors -> out rows of 8 floats (first 8 controls).
int64_t decode_actuator_motors_batch(const uint8_t* data,
                                     const int64_t* offsets, int64_t n,
                                     float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* blob = data + offsets[i];
    size_t blen = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    if (!check_header(blob, blen)) return i;
    Reader r{blob, blen, 4};
    uint64_t ts, tss;
    uint16_t flags;
    if (!r.prim(&ts) || !r.prim(&tss) || !r.prim(&flags)) return i;
    float ctrl[12];
    if (!r.array(ctrl, 12)) return i;
    std::memcpy(out + i * 8, ctrl, 8 * sizeof(float));
  }
  return n;
}

// px4_msgs/msg/VehicleOdometry -> out rows of 13 floats:
// [pos(3), q wxyz(4), vel(3), ang(3)].
int64_t decode_vehicle_odometry_batch(const uint8_t* data,
                                      const int64_t* offsets, int64_t n,
                                      float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* blob = data + offsets[i];
    size_t blen = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    if (!check_header(blob, blen)) return i;
    Reader r{blob, blen, 4};
    uint64_t ts, tss;
    uint8_t pose_frame;
    if (!r.prim(&ts) || !r.prim(&tss) || !r.prim(&pose_frame)) return i;
    float* row = out + i * 13;
    if (!r.array(row, 7)) return i;                   // position3 + q4
    uint8_t vel_frame;
    if (!r.prim(&vel_frame)) return i;
    if (!r.array(row + 7, 6)) return i;               // velocity3 + angvel3
  }
  return n;
}

}  // extern "C"
