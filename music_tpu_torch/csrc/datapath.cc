// music_tpu native data-path kernels.
//
// Host-side hot loops of the data pipeline, C++ for throughput:
//   - mu-law companding encode (float PCM -> uint8/int32 codes)
//   - strided window gather (corpus -> [B, W] training windows)
//   - 16-bit PCM <-> float conversion for WAV I/O
//
// The reference has no native code at all (SURVEY.md §2: pure PyTorch with
// 8 DataLoader worker processes doing per-item one-hot in Python); here the
// equivalent host work is a few vectorized C++ loops behind ctypes, with a
// numpy fallback when no toolchain is available (music_tpu/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC datapath.cc -o libdatapath.so

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// mu-law encode: audio[n] in [-1,1] -> codes[n] in [0, q-1].
// Formula of wavenet/audio_func.py:5-22 in float32 arithmetic.
void mulaw_encode(const float* audio, int32_t* codes, int64_t n, int32_t q) {
  const float mu = static_cast<float>(q - 1);
  const float inv_log1p_mu = 1.0f / std::log1p(mu);
  for (int64_t i = 0; i < n; ++i) {
    float a = audio[i];
    float clipped = a < -1.0f ? -1.0f : (a > 1.0f ? 1.0f : a);
    float mag = std::log1p(mu * std::fabs(clipped)) * inv_log1p_mu;
    float sig = (a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f)) * mag;
    codes[i] = static_cast<int32_t>((sig + 1.0f) * 0.5f * mu + 0.5f);
  }
}

// gather windows: out[b, :] = data[starts[b] : starts[b] + width]
void gather_windows(const int32_t* data, const int64_t* starts,
                    int32_t* out, int64_t batch, int64_t width) {
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out + b * width, data + starts[b],
                width * sizeof(int32_t));
  }
}

// float [-1,1] -> int16 PCM
void float_to_pcm16(const float* audio, int16_t* pcm, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float a = audio[i];
    a = a < -1.0f ? -1.0f : (a > 1.0f ? 1.0f : a);
    pcm[i] = static_cast<int16_t>(a * 32767.0f);
  }
}

// int16 PCM -> float [-1,1]
void pcm16_to_float(const int16_t* pcm, float* audio, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    audio[i] = static_cast<float>(pcm[i]) / 32768.0f;
  }
}

int32_t datapath_abi_version() { return 2; }

}  // extern "C"

// ---------------------------------------------------------------------------
// SMF (MIDI) note-event extraction — the host-side hot loop of the C-RNN-GAN
// data pipeline (music_tpu/data/midi.py:midi_to_song_data; reference analog:
// c-rnn-gan/data.py:100-143 via mido).  Walks every track, pairs note_on
// with the matching note_off (or velocity-0 note_on), normalizes ticks to
// out_tpq resolution, emits [begin_tick, length, freq, velocity] rows.
// Returns the event count, or -1 on any structural error (the Python caller
// falls back to the pure-Python parser, which raises a precise exception).

#include <vector>
#include <algorithm>

namespace {

struct OpenEvent {
  double begin;
  double freq;
  double velocity;
};

inline double tone_to_freq(int note) {
  return 440.0 * std::pow(2.0, (static_cast<double>(note) - 69.0) / 12.0);
}

inline bool read_varlen(const uint8_t* d, int64_t n, int64_t& i, int64_t& value) {
  value = 0;
  for (int k = 0; k < 8; ++k) {  // varlen fields are <= 4 bytes in valid SMF
    if (i >= n) return false;
    uint8_t b = d[i++];
    value = (value << 7) | (b & 0x7F);
    if (!(b & 0x80)) return true;
  }
  return false;
}

inline uint32_t read_u32(const uint8_t* d) {
  return (static_cast<uint32_t>(d[0]) << 24) | (static_cast<uint32_t>(d[1]) << 16) |
         (static_cast<uint32_t>(d[2]) << 8) | static_cast<uint32_t>(d[3]);
}

}  // namespace

extern "C" {

int64_t parse_smf_events(const uint8_t* data, int64_t n, int32_t out_tpq,
                         double* out, int64_t cap) {
  if (n < 14 || std::memcmp(data, "MThd", 4) != 0) return -1;
  uint32_t hlen = read_u32(data + 4);
  if (14 > n || 8 + (int64_t)hlen > n) return -1;
  uint16_t ntrk = (data[10] << 8) | data[11];
  uint16_t division = (data[12] << 8) | data[13];
  if (division & 0x8000) return -1;  // SMPTE unsupported (parity with Python)
  if (division == 0 || out_tpq <= 0) return -1;
  const double scale = static_cast<double>(division) / out_tpq;

  struct Row { double begin, length, freq, velocity; };
  std::vector<Row> song;
  int64_t i = 8 + hlen;
  for (uint16_t t = 0; t < ntrk; ++t) {
    if (i + 8 > n || std::memcmp(data + i, "MTrk", 4) != 0) return -1;
    int64_t tlen = read_u32(data + i + 4);
    int64_t j = i + 8, end = i + 8 + tlen;
    if (end > n) return -1;
    i = end;

    int64_t last_tick = 0;
    uint8_t status = 0;
    std::vector<OpenEvent> open;
    while (j < end) {
      int64_t delta;
      if (!read_varlen(data, end, j, delta)) return -1;
      if (j >= end) return -1;
      uint8_t b = data[j];
      if (b & 0x80) { status = b; ++j; }
      if (status == 0xFF) {  // meta
        if (j >= end) return -1;
        ++j;  // type
        int64_t mlen;
        if (!read_varlen(data, end, j, mlen)) return -1;
        j += mlen;
      } else if (status == 0xF0 || status == 0xF7) {  // sysex
        int64_t mlen;
        if (!read_varlen(data, end, j, mlen)) return -1;
        j += mlen;
      } else {
        uint8_t kind = status & 0xF0;
        int n_data = (kind == 0xC0 || kind == 0xD0) ? 1 : 2;
        if (j + n_data > end) return -1;
        uint8_t a0 = data[j];
        uint8_t a1 = n_data == 2 ? data[j + 1] : 0;
        j += n_data;
        if (kind == 0x80 || (kind == 0x90 && a1 == 0)) {
          const double freq = tone_to_freq(a0);
          const double abs_tick = static_cast<double>(last_tick + delta) / scale;
          std::vector<OpenEvent> kept;
          kept.reserve(open.size());
          for (const OpenEvent& ev : open) {
            if (ev.freq == freq) {
              song.push_back({ev.begin, abs_tick - ev.begin, ev.freq, ev.velocity});
            } else {
              kept.push_back(ev);
            }
          }
          open.swap(kept);
        } else if (kind == 0x90) {
          open.push_back({static_cast<double>(last_tick + delta) / scale,
                          tone_to_freq(a0), static_cast<double>(a1)});
        }
      }
      last_tick += delta;
    }
    for (const OpenEvent& ev : open) {
      song.push_back({ev.begin, static_cast<double>(out_tpq), ev.freq, ev.velocity});
    }
  }
  std::stable_sort(song.begin(), song.end(),
                   [](const Row& a, const Row& b) { return a.begin < b.begin; });
  if (static_cast<int64_t>(song.size()) > cap) return -1;
  for (size_t k = 0; k < song.size(); ++k) {
    out[4 * k + 0] = song[k].begin;
    out[4 * k + 1] = song[k].length;
    out[4 * k + 2] = song[k].freq;
    out[4 * k + 3] = song[k].velocity;
  }
  return static_cast<int64_t>(song.size());
}

}  // extern "C"
