// Segmented WAV reader and writer of pb_chime5_tpu_torch.io.audio.
//
// The front-end is I/O bound on segment reads of long session WAVs (24
// channels x 2.5 h, read per utterance with +-15 s of context).  This
// library does the header parse, the seek and the bulk read in C++, in one
// call that opens the file once, and writes the frames straight into a
// buffer the caller allocates when the call asks for it, so no
// intermediate bytes object is made.  It is the JAX package's
// cpp/wav_ops.cpp with a plain C interface in place of the CPython module
// table: ops/kernels/_build.py compiles it with the host compiler at first
// use and io/audio.py loads it with ctypes, which releases the GIL for the
// length of each call.
//
// Every entry returns 0 on success; the errno of a failed open or seek
// (> 0; the caller raises OSError with the path); PB_VALUE_ERROR,
// PB_OS_ERROR or PB_NO_BUFFER with a message in `err` (the caller raises
// ValueError or OSError with it, or what its allocator raised).
//
//   pb_wav_read(path, start, stop, alloc, header, err, len)
//       frames [start, stop) clamped to the file, stop < 0: to its end,
//       into alloc(nbytes), which is called once; header[5] receives
//       channels, bits, fmt, sample rate and the bytes written, whole
//       frames: a data chunk cut short inside a frame gives the whole
//       frames before the cut
//   pb_wav_write(path, src, nbytes, channels, bits, fmt, rate, err, len)
//       a canonical 44-byte header and the frames
//
// One deviation from the JAX package's parser: an `fmt ` chunk shorter
// than the 16 bytes of its fields raises "truncated fmt chunk", as the
// Python parser (io/wav.py) does, instead of reading past what was read.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>

namespace {

constexpr int PB_VALUE_ERROR = -1;
constexpr int PB_OS_ERROR = -2;
constexpr int PB_NO_BUFFER = -3;

struct WavHeader {
  uint16_t audio_format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  int64_t data_offset = 0;
  int64_t data_bytes = 0;

  int64_t bytes_per_frame() const { return channels * bits / 8; }
  int64_t num_frames() const {
    int64_t bpf = bytes_per_frame();
    return bpf ? data_bytes / bpf : 0;
  }
};

struct FileCloser {
  void operator()(FILE* f) const {
    if (f) fclose(f);
  }
};
using FilePtr = std::unique_ptr<FILE, FileCloser>;

int fail(char* err, int64_t err_len, int code, const char* path,
         const char* what) {
  if (err_len > 0) snprintf(err, static_cast<size_t>(err_len), what, path);
  return code;
}

// Moves `n` bytes on; a stream that cannot seek (a pipe) is read through.
// Past the end it stops there: the next chunk header is then missing.
void skip(FILE* f, int64_t n) {
  if (n <= 0 || fseeko(f, static_cast<off_t>(n), SEEK_CUR) == 0) return;
  char sink[4096];
  while (n > 0) {
    size_t want = n < int64_t{sizeof(sink)} ? static_cast<size_t>(n)
                                            : sizeof(sink);
    if (fread(sink, 1, want, f) != want) return;
    n -= static_cast<int64_t>(want);
  }
}

// Walks the chunks up to `data`; the file is left at the first frame.
// Positions are counted, not asked of the stream (no ftello), chunks are
// skipped by `skip`, and a read from frame 0 seeks nowhere, so a header
// and the frames that follow it can also come from a pipe.
int parse_header(FILE* f, const char* path, WavHeader* h, char* err,
                 int64_t err_len) {
  char magic[12];
  if (fread(magic, 1, 12, f) != 12 || memcmp(magic, "RIFF", 4) != 0 ||
      memcmp(magic + 8, "WAVE", 4) != 0)
    return fail(err, err_len, PB_VALUE_ERROR, path,
                "%s: not a RIFF/WAVE file");
  int64_t pos = 12;
  bool have_fmt = false;
  for (;;) {
    char chunk[8];
    if (fread(chunk, 1, 8, f) != 8)
      return fail(err, err_len, PB_VALUE_ERROR, path,
                  "%s: no data chunk found");
    pos += 8;
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      size_t want = size < sizeof(fmt) ? size : sizeof(fmt);
      if (want < 16 || fread(fmt, 1, want, f) != want)
        return fail(err, err_len, PB_VALUE_ERROR, path,
                    "%s: truncated fmt chunk");
      skip(f, int64_t{size} - static_cast<int64_t>(want));
      pos += size;
      memcpy(&h->audio_format, fmt, 2);
      memcpy(&h->channels, fmt + 2, 2);
      memcpy(&h->sample_rate, fmt + 4, 4);
      memcpy(&h->bits, fmt + 14, 2);
      if (h->audio_format == 0xFFFE && size >= 40) {
        memcpy(&h->audio_format, fmt + 24, 2);  // WAVE_FORMAT_EXTENSIBLE
      }
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      if (!have_fmt)
        return fail(err, err_len, PB_VALUE_ERROR, path,
                    "%s: data before fmt chunk");
      h->data_offset = pos;
      h->data_bytes = size;
      return 0;
    } else {
      int64_t padded = int64_t{size} + (size & 1);
      skip(f, padded);
      pos += padded;
    }
  }
}

}  // namespace

// The caller's allocator: a buffer of `nbytes` that outlives the call,
// or NULL when it could not make one.
typedef void* (*pb_alloc_fn)(int64_t nbytes);

extern "C" int pb_wav_read(const char* path, int64_t start, int64_t stop,
                           pb_alloc_fn alloc, int64_t* header, char* err,
                           int64_t err_len) {
  FilePtr f(fopen(path, "rb"));
  if (!f) return errno ? errno : EIO;
  WavHeader h;
  if (int code = parse_header(f.get(), path, &h, err, err_len)) return code;
  header[0] = h.channels;
  header[1] = h.bits;
  header[2] = h.audio_format;
  header[3] = h.sample_rate;
  header[4] = 0;
  int64_t frames = h.num_frames();
  if (stop < 0 || stop > frames) stop = frames;
  if (start < 0) start = 0;
  if (start > frames) start = frames;
  int64_t count = stop > start ? stop - start : 0;
  int64_t nbytes = count * h.bytes_per_frame();
  void* dst = alloc(nbytes);
  if (!dst)
    return fail(err, err_len, PB_NO_BUFFER, path,
                "%s: no buffer for the frames");
  if (nbytes == 0) return 0;
  if (start > 0 && fseeko(f.get(), h.data_offset + start * h.bytes_per_frame(),
                          SEEK_SET) != 0)
    return errno ? errno : EIO;
  int64_t read = static_cast<int64_t>(
      fread(dst, 1, static_cast<size_t>(nbytes), f.get()));
  // tolerate truncated files: what was read, rounded down to whole frames
  header[4] = (read / h.bytes_per_frame()) * h.bytes_per_frame();
  return 0;
}

extern "C" int pb_wav_write(const char* path, const void* src, int64_t nbytes,
                            int32_t channels_in, int32_t bits_in,
                            int32_t fmt_in, int64_t rate_in, char* err,
                            int64_t err_len) {
  FilePtr f(fopen(path, "wb"));
  if (!f) return errno ? errno : EIO;
  uint16_t channels = static_cast<uint16_t>(channels_in);
  uint16_t bits = static_cast<uint16_t>(bits_in);
  uint16_t audio_format = static_cast<uint16_t>(fmt_in);
  uint32_t sample_rate = static_cast<uint32_t>(rate_in);
  uint32_t data_bytes = static_cast<uint32_t>(nbytes);
  uint32_t byte_rate = sample_rate * channels * bits / 8;
  uint16_t block_align = channels * bits / 8;
  unsigned char header[44];
  memcpy(header, "RIFF", 4);
  uint32_t riff = 36 + data_bytes;
  memcpy(header + 4, &riff, 4);
  memcpy(header + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(header + 16, &fmt_size, 4);
  memcpy(header + 20, &audio_format, 2);
  memcpy(header + 22, &channels, 2);
  memcpy(header + 24, &sample_rate, 4);
  memcpy(header + 28, &byte_rate, 4);
  memcpy(header + 32, &block_align, 2);
  memcpy(header + 34, &bits, 2);
  memcpy(header + 36, "data", 4);
  memcpy(header + 40, &data_bytes, 4);
  bool ok = fwrite(header, 1, 44, f.get()) == 44 &&
            fwrite(src, 1, static_cast<size_t>(nbytes), f.get()) ==
                static_cast<size_t>(nbytes);
  ok = (fclose(f.release()) == 0) && ok;
  if (!ok) return fail(err, err_len, PB_OS_ERROR, path, "short write to %s");
  return 0;
}
