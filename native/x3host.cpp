// x3tpu native host codec.
//
// A from-scratch C++17 implementation of the x3 stream format's behavioral
// contract (SURVEY.md §0; reference semantics cited per member below).  This
// is the framework's host-side runtime path: a fast CPU fallback for inputs
// too small to be worth a device launch, and a bit-exact cross-check oracle
// for the device codec at corpus scale (the NumPy spec is exact but slow).
//
// Design intentionally differs from the reference C implementation: the
// dictionary keeps entries in insertion order with a recency *permutation*
// maintained by move-to-front (provably equivalent to the reference's
// per-event cost re-sort; see x3tpu/models/dictionary.py), contexts are
// per-id item vectors, and the (tag,tag)->id map is a hash map (ids are
// insertion-ordered, which is all the format observes).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC x3host.cpp -o libx3host.so

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace x3host {

constexpr uint32_t kTop = 0x7FFFFFFF;        // ac.c:31-41
constexpr uint32_t kFirstQuarter = 0x20000000;
constexpr uint32_t kHalf = 0x40000000;
constexpr uint32_t kThirdQuarter = 0x60000000;
constexpr int kMaxMatch = 32;                 // backend.h:6-10

enum Event { E_CTX0 = 0, E_CTX1, E_IDX1, E_NEW, E_EOF, E_LAST };  // x3.c:33-40

struct Params {
  int max_match_count = 15;   // -t, backend.c:21
  int64_t window = 8 * 1024;  // -w, backend.c:8
  int64_t factor1 = 4;        // -m, backend.c:33
  int64_t factor2 = 0;        // -n, backend.c:34
  int nl_remap = 0;           // -x, x3.c:357-370
};

// ---- bit I/O: LSB-first into LE u32 words (bio.c) -------------------------

class BitWriter {
 public:
  void put(uint32_t bit) {
    acc_ |= (bit & 1u) << n_;
    if (++n_ == 32) { words_.push_back(acc_); acc_ = 0; n_ = 0; }
  }
  std::vector<uint8_t> close() {
    if (n_ > 0) { words_.push_back(acc_); acc_ = 0; n_ = 0; }
    std::vector<uint8_t> out(words_.size() * 4);
    for (size_t i = 0; i < words_.size(); ++i) {
      uint32_t w = words_[i];
      out[4 * i] = w & 0xff; out[4 * i + 1] = (w >> 8) & 0xff;
      out[4 * i + 2] = (w >> 16) & 0xff; out[4 * i + 3] = (w >> 24) & 0xff;
    }
    return out;
  }
 private:
  std::vector<uint32_t> words_;
  uint32_t acc_ = 0;
  int n_ = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) {
    size_t n_words = size >= 4 ? (size - 4) / 4 + 1 : 0;  // end-3 rule, bio.c:11
    words_.reserve(n_words);
    for (size_t i = 0; i < n_words; ++i) {
      words_.push_back(uint32_t(data[4 * i]) | uint32_t(data[4 * i + 1]) << 8 |
                       uint32_t(data[4 * i + 2]) << 16 |
                       uint32_t(data[4 * i + 3]) << 24);
    }
  }
  uint32_t get() {
    if (used_ == 32) {
      acc_ = idx_ < words_.size() ? words_[idx_++] : 0x80000000u;  // bio.c:38
      used_ = 0;
    }
    uint32_t b = acc_ & 1u;
    acc_ >>= 1;
    ++used_;
    return b;
  }
 private:
  std::vector<uint32_t> words_;
  size_t idx_ = 0;
  uint32_t acc_ = 0;
  int used_ = 32;
};

// ---- adaptive frequency model (ac.c:200-273) ------------------------------

class Model {
 public:
  explicit Model(size_t n = 0) : freq_(n, 1), total_(n) {}
  void seed(std::vector<uint64_t> f) {
    freq_ = std::move(f);
    total_ = 0;
    for (auto v : freq_) total_ += v;
  }
  size_t size() const { return freq_.size(); }
  uint64_t total() const { return total_; }
  uint64_t freq(size_t s) const { return freq_[s]; }
  uint64_t low(size_t s) const {
    uint64_t acc = 0;
    for (size_t i = 0; i < s; ++i) acc += freq_[i];
    return acc;
  }
  void inc(size_t s) { ++freq_[s]; ++total_; }
  void grow() { freq_.push_back(1); ++total_; }
  float prob(size_t s) const {  // (float)freq/total, ac.c:108-113
    return float(freq_[s]) / float(total_);
  }
  // decode: find s with low(s) <= v < low(s)+freq(s); returns (s, low)
  size_t find(uint64_t v, uint64_t* lo) const {
    uint64_t acc = 0;
    for (size_t i = 0; i < freq_.size(); ++i) {
      if (v < acc + freq_[i]) { *lo = acc; return i; }
      acc += freq_[i];
    }
    // corrupt stream (the reference aborts here, ac.c:178; we surface an
    // error code through the C ABI instead of killing the host process)
    throw std::runtime_error("x3host: corrupt stream (symbol out of range)");
  }
 private:
  std::vector<uint64_t> freq_;
  uint64_t total_ = 0;
};

// ---- 31-bit arithmetic coder (ac.c) ---------------------------------------

class Encoder {
 public:
  explicit Encoder(BitWriter* out) : out_(out) {}
  void encode(uint64_t lo, uint64_t hi, uint64_t total) {  // ac.c:77-85
    uint64_t step = (high_ - low_ + 1) / total;
    high_ = low_ + step * hi - 1;
    low_ = low_ + step * lo;
    while (high_ < kHalf || low_ >= kHalf) {  // E1/E2, ac.c:46-67
      if (high_ < kHalf) {
        out_->put(0);
        low_ *= 2; high_ = 2 * high_ + 1;
        for (; scale_ > 0; --scale_) out_->put(1);
      } else {
        out_->put(1);
        low_ = 2 * (low_ - kHalf); high_ = 2 * (high_ - kHalf) + 1;
        for (; scale_ > 0; --scale_) out_->put(0);
      }
    }
    while (kFirstQuarter <= low_ && high_ < kThirdQuarter) {  // E3, ac.c:70-74
      ++scale_;
      low_ = 2 * (low_ - kFirstQuarter); high_ = 2 * (high_ - kFirstQuarter) + 1;
    }
  }
  void encode_sym(const Model& m, size_t s) {
    uint64_t lo = m.low(s);
    encode(lo, lo + m.freq(s), m.total());
  }
  void flush() {  // ac.c:115-126
    if (low_ < kFirstQuarter) {
      out_->put(0);
      for (uint64_t i = 0; i < scale_ + 1; ++i) out_->put(1);
    } else {
      out_->put(1);
    }
  }
 private:
  BitWriter* out_;
  uint64_t low_ = 0, high_ = kTop, scale_ = 0;
};

class Decoder {
 public:
  explicit Decoder(BitReader* in) : in_(in) {
    for (int i = 0; i < 31; ++i) buf_ = (buf_ << 1) | in_->get();  // ac.c:133-140
  }
  size_t decode_sym(const Model& m) {
    // guards: on a VALID stream total <= range and step >= 1 always
    // (ac.c invariants), so the clamps never fire; on a CORRUPT stream
    // they turn a SIGFPE div-by-zero into a normal bad-symbol path that
    // the caller's bounds checks catch (a corrupt stream once crashed
    // the bench round-trip with rc=136 instead of reporting)
    uint64_t tot = m.total() ? m.total() : 1;
    uint64_t step = (high_ - low_ + 1) / tot;
    if (step == 0) step = 1;
    uint64_t value = (buf_ - low_) / step;
    uint64_t lo;
    size_t s = m.find(value, &lo);
    high_ = low_ + step * (lo + m.freq(s)) - 1;
    low_ = low_ + step * lo;
    while (high_ < kHalf || low_ >= kHalf) {  // ac.c:142-156
      if (high_ < kHalf) {
        low_ *= 2; high_ = 2 * high_ + 1; buf_ = 2 * buf_ + in_->get();
      } else {
        low_ = 2 * (low_ - kHalf); high_ = 2 * (high_ - kHalf) + 1;
        buf_ = 2 * (buf_ - kHalf) + in_->get();
      }
    }
    while (kFirstQuarter <= low_ && high_ < kThirdQuarter) {  // ac.c:159-164
      low_ = 2 * (low_ - kFirstQuarter); high_ = 2 * (high_ - kFirstQuarter) + 1;
      buf_ = 2 * (buf_ - kFirstQuarter) + in_->get();
    }
    return s;
  }
 private:
  BitReader* in_;
  uint64_t low_ = 0, high_ = kTop, buf_ = 0;
};

// ---- dictionary with recency permutation (dict.c, MTF-equivalent) ---------

struct Entry {
  uint8_t s[kMaxMatch];
  int len = 0;
};

class Dict {
 public:
  size_t size() const { return entries_.size(); }
  // longest entry that prefixes text (dict.c:105-130); -1 if none.
  // The longest match is unique (two same-length prefixes of one text
  // are byte-identical and exact duplicates never enter, dict.c:148),
  // so a per-length hash index answers it in <= kMaxMatch lookups
  // instead of an O(entries) memcmp scan — same result, hot-loop speed.
  long find(const uint8_t* text) const {
    for (int l = kMaxMatch; l >= 1; --l) {
      const auto& m = by_len_[l];
      if (m.empty()) continue;
      auto it = m.find(fnv_(text, l));
      if (it == m.end()) continue;
      for (size_t t : it->second)
        if (std::memcmp(text, entries_[t].s, l) == 0) return long(t);
    }
    return -1;
  }
  bool has_exact(const uint8_t* frag, int len) const {  // dict.c:148-157
    auto it = by_len_[len].find(fnv_(frag, len));
    if (it == by_len_[len].end()) return false;
    for (size_t t : it->second)
      if (std::memcmp(frag, entries_[t].s, len) == 0) return true;
    return false;
  }
  // insert at recency rank 0 (new entry's last_pos is maximal)
  size_t insert(const uint8_t* frag, int len) {
    size_t tag = append_(frag, len);
    tag_of_rank_.insert(tag_of_rank_.begin(), tag);
    rank_of_tag_.push_back(0);
    for (size_t r = 1; r < tag_of_rank_.size(); ++r)
      rank_of_tag_[tag_of_rank_[r]] = r;
    return tag;
  }
  // move-to-front == dict_update_costs after a hit (dict.c:132-146)
  void touch(size_t tag) {
    size_t r = rank_of_tag_[tag];
    tag_of_rank_.erase(tag_of_rank_.begin() + r);
    tag_of_rank_.insert(tag_of_rank_.begin(), tag);
    for (size_t i = 0; i <= r; ++i) rank_of_tag_[tag_of_rank_[i]] = i;
    ++uses_[tag];
  }
  uint64_t uses(size_t tag) const {
    auto it = uses_.find(tag);
    return it == uses_.end() ? 0 : it->second;
  }
  // seed-dictionary append (x3tpu extension, codec.py:_init_shared):
  // tag i lands at recency rank i (identity permutation) — all seeds
  // share last_pos 0 and the reference's stable cost sort preserves
  // insertion order among ties, unlike insert()'s rank-0 placement.
  void seed_append(const uint8_t* frag, int len) {
    size_t tag = append_(frag, len);
    tag_of_rank_.push_back(tag);
    rank_of_tag_.push_back(tag);
  }
  size_t rank_of(size_t tag) const { return rank_of_tag_[tag]; }
  size_t tag_at(size_t rank) const { return tag_of_rank_[rank]; }
  int len_of(size_t tag) const { return entries_[tag].len; }
  const uint8_t* str_of(size_t tag) const { return entries_[tag].s; }

 private:
  static uint64_t fnv_(const uint8_t* p, int len) {
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < len; ++i) { h ^= p[i]; h *= 1099511628211ull; }
    return h;
  }
  size_t append_(const uint8_t* frag, int len) {
    Entry e;
    std::memcpy(e.s, frag, len);
    e.len = len;
    entries_.push_back(e);
    size_t tag = entries_.size() - 1;
    by_len_[len][fnv_(frag, len)].push_back(tag);
    return tag;
  }
  std::vector<Entry> entries_;        // by tag (insertion id, dict.c:100)
  std::vector<size_t> rank_of_tag_;
  std::vector<size_t> tag_of_rank_;
  // per-length prefix index: hash64(first len bytes) -> tags of that len
  std::array<std::unordered_map<uint64_t, std::vector<size_t>>,
             kMaxMatch + 1> by_len_;
  std::unordered_map<size_t, uint64_t> uses_;  // touch counts (seed training)
};

// ---- contexts + pair map (context.c, tag_pair.c) --------------------------

struct CtxItem { size_t tag; uint64_t freq; };

using Ctx = std::vector<CtxItem>;  // insertion order == symbol order

struct PairHash {
  size_t operator()(const std::pair<size_t, size_t>& p) const {
    return p.first * 0x9E3779B97F4A7C15ull ^ (p.second + 0x7F4A7C15ull);
  }
};

static long ctx_index_of(const Ctx& c, size_t tag) {
  for (size_t i = 0; i < c.size(); ++i)
    if (c[i].tag == tag) return long(i);
  return -1;
}

static Model ctx_model(const Ctx& c) {  // throwaway model, context.c:95-112
  Model m;
  std::vector<uint64_t> f(c.size());
  for (size_t i = 0; i < c.size(); ++i) f[i] = c[i].freq;
  m.seed(std::move(f));
  return m;
}

// ---- the codec ------------------------------------------------------------

class Codec {
 public:
  explicit Codec(const Params& p) : params_(p) {
    std::vector<uint64_t> ev(E_LAST, 1);
    ev[E_CTX0] = 1024; ev[E_CTX1] = 1024;  // x3.c:238-244
    events_.seed(std::move(ev));
    match_size_ = Model(kMaxMatch);
    chars_ = Model(256);
    index1_ = Model(0);
    ctx0_.emplace_back();  // fallback context id 0 (x3.c:63-67)
  }

  std::vector<uint8_t> encode(const uint8_t* data, size_t size);
  std::vector<uint8_t> decode(const uint8_t* data, size_t size,
                              size_t max_output);
  // dictionary-seed broadcast (x3tpu extension; mirrors
  // codec.py:_init_shared): K fragments pre-inserted with identity
  // recency ranks, one empty ctx1 row and one index-model symbol
  // (freq 1) per seed.  Encoder and decoder must share the seeds.
  void seed(const uint8_t* strs, const int32_t* lens, size_t k) {
    for (size_t i = 0; i < k; ++i) {
      dict_.seed_append(strs + i * kMaxMatch, lens[i]);
      ctx1_.emplace_back();
      index1_.grow();
    }
  }
  // dump up to k dictionary entries (seed training).  order 0: insertion;
  // order 1: by descending use count (hot fragments first, so the seeded
  // block starts them at low MTF ranks), ties by insertion order.
  size_t dump_dict(uint8_t* strs, int32_t* lens, size_t k,
                   int order = 0) const {
    size_t n = dict_.size() < k ? dict_.size() : k;
    std::vector<size_t> tags(dict_.size());
    for (size_t t = 0; t < tags.size(); ++t) tags[t] = t;
    if (order == 1) {
      std::stable_sort(tags.begin(), tags.end(),
                       [this](size_t a, size_t b) {
                         return dict_.uses(a) > dict_.uses(b);
                       });
    }
    for (size_t i = 0; i < n; ++i) {
      std::memcpy(strs + i * kMaxMatch, dict_.str_of(tags[i]), kMaxMatch);
      lens[i] = dict_.len_of(tags[i]);
    }
    return n;
  }
  // Model warm-start (x3tpu container-v2 extension): replay the tape of
  // seed indices through the context/pair update rule of x3.c:195-222
  // under fixed caps, mirroring x3tpu/warm.py:replay EXACTLY — the rule
  // is part of the versioned format and every implementation must agree
  // (ctx1 item append and pair registration stay 1:1 so inline-pair
  // layouts match this hash map).  Call after seed(), before coding.
  static constexpr long kWarmReset = -1;     // wire format: 0xFFFF
  static constexpr size_t kWarmHubCap = 1024;
  static constexpr size_t kWarmRowCap = 16;
  static constexpr size_t kWarmPairCap = 4096;
  void warm_start(const int32_t* tape, size_t tn) {
    size_t prev = 0, c1 = 0;
    for (size_t i = 0; i < tn; ++i) {
      long s = tape[i];
      if (s == kWarmReset) { prev = 0; c1 = 0; continue; }
      if (s < 0 || size_t(s) >= ctx1_.size())
        throw std::runtime_error("warm tape entry out of range");
      size_t tag = size_t(s);
      {
        Ctx& c0 = resolve_ctx0(prev, c1);
        bool hub0 = &c0 == &ctx0_[0];
        long i0 = ctx_index_of(c0, tag);
        size_t cap0 = hub0 ? kWarmHubCap : kWarmRowCap;
        if (i0 >= 0) ++c0[i0].freq;
        else if (c0.size() < cap0) c0.push_back({tag, 1});
      }
      Ctx& c1t = ctx1_[c1];
      long i1 = ctx_index_of(c1t, tag);
      if (i1 >= 0) {
        ++c1t[i1].freq;
      } else {
        size_t cap1 = (c1 == 0) ? kWarmHubCap : kWarmRowCap;
        if (c1t.size() < cap1 && pairs_.size() < kWarmPairCap) {
          c1t.push_back({tag, 1});
          auto key = std::make_pair(c1, tag);
          if (pairs_.find(key) == pairs_.end()) {
            size_t id = pairs_.size();
            pairs_.emplace(key, id);
            if (id != 0) ctx0_.emplace_back();
          }
        }
      }
      prev = c1;
      c1 = tag;
    }
  }
  // Event-tape recording (seed training): when set, encode() appends one
  // entry per event — the hit tag, or kWarmReset for E_NEW (the real
  // stream resets the context chain there, x3.c:423-425).
  void record_tape(std::vector<long>* rec) { tape_rec_ = rec; }
  // Translate a recorded raw tape to seed indices under a kept-tag order
  // (dump_dict's `tags` permutation truncated to n): entries whose tag
  // was not kept become kWarmReset (the chain is broken for the warm
  // replay exactly as if unseen).
  static void map_tape(const std::vector<long>& raw,
                       const std::vector<size_t>& kept_tags,
                       std::vector<int32_t>* out) {
    std::unordered_map<size_t, int32_t> idx;
    for (size_t i = 0; i < kept_tags.size(); ++i)
      idx.emplace(kept_tags[i], int32_t(i));
    for (long t : raw) {
      if (t >= 0) {
        auto it = idx.find(size_t(t));
        out->push_back(it == idx.end() ? int32_t(kWarmReset)
                                       : it->second);
      } else {
        out->push_back(int32_t(kWarmReset));
      }
    }
  }
  // the dump_dict tag permutation (shared by dump_dict and tape mapping)
  std::vector<size_t> dump_order(size_t k, int order) const {
    std::vector<size_t> tags(dict_.size());
    for (size_t t = 0; t < tags.size(); ++t) tags[t] = t;
    if (order == 1) {
      std::stable_sort(tags.begin(), tags.end(),
                       [this](size_t a, size_t b) {
                         return dict_.uses(a) > dict_.uses(b);
                       });
    }
    if (tags.size() > k) tags.resize(k);
    return tags;
  }

  // state-growth measurement for static-capacity tuning.  Non-hub rows
  // longer than small_cap outgrow the device codec's small pool and are
  // promoted to a big row (models/context.py); the big-row pool is a
  // per-lane resource that must be sized too (CodecCaps.ctx_promo_rows).
  void measure(size_t small_cap, int64_t* out) const {
    out[0] = int64_t(dict_.size());
    out[1] = int64_t(pairs_.size());
    size_t hub0 = ctx0_.empty() ? 0 : ctx0_[0].size();
    size_t max0 = 0, promo0 = 0;
    for (size_t i = 1; i < ctx0_.size(); ++i) {
      size_t n = ctx0_[i].size();
      if (n > max0) max0 = n;
      if (n > small_cap) ++promo0;
    }
    size_t hub1 = ctx1_.empty() ? 0 : ctx1_[0].size();
    size_t max1 = 0, promo1 = 0;
    for (size_t i = 1; i < ctx1_.size(); ++i) {
      size_t n = ctx1_[i].size();
      if (n > max1) max1 = n;
      if (n > small_cap) ++promo1;
    }
    out[2] = int64_t(hub0);
    out[3] = int64_t(max0);
    out[4] = int64_t(hub1);
    out[5] = int64_t(max1);
    out[6] = int64_t(promo0);
    out[7] = int64_t(promo1);
  }

 private:
  size_t nl(size_t len) const {  // x3.c:357-370
    if (!params_.nl_remap) return len;
    switch (len - 1) { case 0: return 1; case 1: return 4;
                       case 2: return 6; case 3: return 8; default: return 9999; }
  }
  size_t find_best_match(const uint8_t* p, const uint8_t* hard_end) const;
  void update_contexts(Ctx& c0, size_t context1, size_t tag);
  Ctx& resolve_ctx0(size_t prev_c1, size_t c1) {
    auto it = pairs_.find({prev_c1, c1});
    return ctx0_[it == pairs_.end() ? 0 : it->second];
  }

  Params params_;
  Dict dict_;
  Model events_, match_size_, chars_, index1_;
  std::vector<Ctx> ctx0_;  // by pair id; [0] shared with fallback
  std::vector<Ctx> ctx1_;  // by tag
  std::unordered_map<std::pair<size_t, size_t>, size_t, PairHash> pairs_;
  std::vector<long>* tape_rec_ = nullptr;  // event-tape recorder (training)
};

// window scan + threshold sweep + magic vetoes (backend.c:56-100)
size_t Codec::find_best_match(const uint8_t* p, const uint8_t* hard_end) const {
  size_t count[kMaxMatch] = {0};
  const uint8_t* end = p + params_.window;
  for (const uint8_t* s = p + 1; s < end - kMaxMatch; ++s) {
    for (int i = 0; i < kMaxMatch; ++i) {
      if (p[i] == s[i]) ++count[i]; else break;
    }
  }
  (void)hard_end;
  for (int tc = params_.max_match_count; tc > 0; --tc) {
    for (int i = kMaxMatch - 1; i >= 0; --i) {
      if (count[i] > size_t(tc)) {
        if (i >= 2 && params_.factor1 > 0) {
          long d = dict_.find(p + i);
          if (d != -1 && uint64_t(dict_.len_of(d)) * params_.factor1 >
                             uint64_t(i + 1))
            continue;  // backend.c:79-83
        }
        if (i >= 1 && params_.factor2 > 0) {
          bool vetoed = false;
          for (int o = 1; o <= i; ++o) {
            long d = dict_.find(p + o);
            if (d != -1 &&
                (long(dict_.len_of(d)) - o) * long(params_.factor2) > i + 1) {
              vetoed = true;  // backend.c:84-90
              break;
            }
          }
          if (vetoed) continue;
        }
        return size_t(i) + 1;
      }
    }
  }
  return 1;
}

void Codec::update_contexts(Ctx& c0, size_t context1, size_t tag) {
  // bump tag in both contexts, register the (context1, tag) pair
  // (x3.c:195-222 == x3.c:99-127)
  long i0 = ctx_index_of(c0, tag);
  if (i0 < 0) c0.push_back({tag, 1}); else ++c0[i0].freq;
  Ctx& c1t = ctx1_[context1];
  long i1 = ctx_index_of(c1t, tag);
  if (i1 < 0) c1t.push_back({tag, 1}); else ++c1t[i1].freq;
  auto key = std::make_pair(context1, tag);
  if (pairs_.find(key) == pairs_.end()) {
    size_t id = pairs_.size();
    pairs_.emplace(key, id);
    if (id != 0) ctx0_.emplace_back();  // id 0 shares the fallback table
  }
}

std::vector<uint8_t> Codec::encode(const uint8_t* data, size_t size) {
  // zero-pad the tail so window scans never read uninitialized memory
  // (x3.c:579/590)
  size_t pad = size_t(params_.window) + kMaxMatch;
  std::vector<uint8_t> buf(size + pad, 0);
  if (size) std::memcpy(buf.data(), data, size);
  const uint8_t* base = buf.data();

  BitWriter out;
  Encoder enc(&out);
  size_t prev_c1 = 0, c1 = 0;

  for (size_t p = 0; p < size;) {
    long tag = dict_.find(base + p);  // x3.c:381
    size_t dlen = tag >= 0 ? size_t(dict_.len_of(tag)) : 0;
    size_t best = find_best_match(base + p, base + size);
    if (tag >= 0 && nl(dlen) >= best && p + dlen <= size) {
      // --- dictionary hit: pick cheapest coding (x3.c:150-190)
      Ctx& c0 = resolve_ctx0(prev_c1, c1);
      Ctx& c1t = ctx1_[c1];
      size_t rank = dict_.rank_of(tag);
      long i0 = ctx_index_of(c0, tag);
      long i1 = ctx_index_of(c1t, tag);
      float prob0 = 0.f, prob1 = 0.f;
      Model m0, m1;
      if (i0 >= 0) { m0 = ctx_model(c0); prob0 = events_.prob(E_CTX0) * m0.prob(i0); }
      if (i1 >= 0) { m1 = ctx_model(c1t); prob1 = events_.prob(E_CTX1) * m1.prob(i1); }
      float probx = events_.prob(E_IDX1) * index1_.prob(rank);
      int mode = E_IDX1;
      float prob = probx;
      if (prob0 > prob) { mode = E_CTX0; prob = prob0; }
      if (prob1 > prob) { mode = E_CTX1; prob = prob1; }

      enc.encode_sym(events_, mode);
      events_.inc(mode);
      if (mode == E_CTX0) enc.encode_sym(m0, i0);
      else if (mode == E_CTX1) enc.encode_sym(m1, i1);
      else { enc.encode_sym(index1_, rank); index1_.inc(rank); }

      update_contexts(c0, c1, tag);
      prev_c1 = c1;
      c1 = tag;
      dict_.touch(tag);
      if (tape_rec_) tape_rec_->push_back(long(tag));
      p += dlen;
    } else {
      // --- new fragment (x3.c:398-428)
      size_t len = best;
      if (p + len > size) len = size - p;
      if (tape_rec_) tape_rec_->push_back(kWarmReset);
      enc.encode_sym(events_, E_NEW);
      events_.inc(E_NEW);
      enc.encode_sym(match_size_, len - 1);
      match_size_.inc(len - 1);
      for (size_t c = 0; c < len; ++c) {
        enc.encode_sym(chars_, base[p + c]);
        chars_.inc(base[p + c]);
      }
      if (!dict_.has_exact(base + p, len)) {
        dict_.insert(base + p, len);
        ctx1_.emplace_back();
        index1_.grow();
      }
      prev_c1 = 0;
      c1 = 0;
      p += len;
    }
  }
  enc.encode_sym(events_, E_EOF);  // x3.c:432-433
  events_.inc(E_EOF);
  enc.flush();
  return out.close();
}

std::vector<uint8_t> Codec::decode(const uint8_t* data, size_t size,
                                   size_t max_output) {
  BitReader in(data, size);
  Decoder dec(&in);
  std::vector<uint8_t> out;
  out.reserve(std::min<size_t>(max_output, size * 8 + 64));
  size_t prev_c1 = 0, c1 = 0;

  for (;;) {
    size_t decision = dec.decode_sym(events_);
    events_.inc(decision);
    if (decision == E_EOF) break;
    if (decision == E_NEW) {
      size_t len = dec.decode_sym(match_size_) + 1;
      match_size_.inc(len - 1);
      uint8_t frag[kMaxMatch];
      for (size_t c = 0; c < len; ++c) {
        frag[c] = uint8_t(dec.decode_sym(chars_));
        chars_.inc(frag[c]);
      }
      if (!dict_.has_exact(frag, len)) {
        dict_.insert(frag, len);
        ctx1_.emplace_back();
        index1_.grow();
      }
      if (out.size() + len > max_output)
        throw std::length_error("x3host: output cap exceeded");
      out.insert(out.end(), frag, frag + len);
      prev_c1 = 0;
      c1 = 0;
    } else {
      // bounds guards: never fire on a valid stream (every id the
      // decoder stores is in range by construction) but a CORRUPT
      // stream can leave stale out-of-range ids here — surface the
      // normal corrupt-stream error instead of UB (round-5 corrupt
      // fuzz: a null Ctx reference segfaulted through the C ABI)
      if (c1 >= ctx1_.size())
        throw std::runtime_error("x3host: corrupt stream (bad context)");
      Ctx& c0 = resolve_ctx0(prev_c1, c1);
      Ctx& c1t = ctx1_[c1];
      size_t tag;
      if (decision == E_CTX0) {
        tag = c0[dec.decode_sym(ctx_model(c0))].tag;
      } else if (decision == E_CTX1) {
        tag = c1t[dec.decode_sym(ctx_model(c1t))].tag;
      } else {
        size_t rank = dec.decode_sym(index1_);
        index1_.inc(rank);
        tag = dict_.tag_at(rank);
      }
      if (tag >= dict_.size())  // see the corrupt-stream guard above
        throw std::runtime_error("x3host: corrupt stream (bad tag)");
      update_contexts(c0, c1, tag);
      size_t len = dict_.len_of(tag);
      if (out.size() + len > max_output)
        throw std::length_error("x3host: output cap exceeded");
      out.insert(out.end(), dict_.str_of(tag), dict_.str_of(tag) + len);
      prev_c1 = c1;
      c1 = tag;
      dict_.touch(tag);
    }
  }
  return out;
}

}  // namespace x3host

// ---- C ABI ----------------------------------------------------------------

extern "C" {

// Returns 0 on success.  *out is malloc'd; caller frees with x3h_free.
int x3h_encode(const uint8_t* data, size_t size, int max_match_count,
               long window, long factor1, long factor2, int nl_remap,
               uint8_t** out, size_t* out_size) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  auto res = codec.encode(data, size);
  *out = static_cast<uint8_t*>(std::malloc(res.size() ? res.size() : 1));
  std::memcpy(*out, res.data(), res.size());
  *out_size = res.size();
  return 0;
}

// Returns 0 on success, 2 when the output cap was exceeded (retryable
// with a larger max_output), 1 on a corrupt stream.
int x3h_decode(const uint8_t* data, size_t size, size_t max_output,
               uint8_t** out, size_t* out_size) {
  x3host::Params p;
  x3host::Codec codec(p);
  try {
    auto res = codec.decode(data, size, max_output);
    *out = static_cast<uint8_t*>(std::malloc(res.size() ? res.size() : 1));
    std::memcpy(*out, res.data(), res.size());
    *out_size = res.size();
    return 0;
  } catch (const std::length_error&) {
    return 2;
  } catch (const std::exception&) {
    return 1;
  }
}

// Seeded variants: seeds are k fragments (strs: k x 32 bytes row-major,
// lens: k entries) pre-inserted into the dictionary before coding —
// the x3tpu seed-broadcast extension (parallel/blocks.py carries them).
int x3h_encode_seeded(const uint8_t* data, size_t size, int max_match_count,
                      long window, long factor1, long factor2, int nl_remap,
                      const uint8_t* seed_strs, const int32_t* seed_lens,
                      size_t seed_k, uint8_t** out, size_t* out_size) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  codec.seed(seed_strs, seed_lens, seed_k);
  auto res = codec.encode(data, size);
  *out = static_cast<uint8_t*>(std::malloc(res.size() ? res.size() : 1));
  std::memcpy(*out, res.data(), res.size());
  *out_size = res.size();
  return 0;
}

int x3h_decode_seeded(const uint8_t* data, size_t size, size_t max_output,
                      const uint8_t* seed_strs, const int32_t* seed_lens,
                      size_t seed_k, uint8_t** out, size_t* out_size) {
  x3host::Params p;
  x3host::Codec codec(p);
  codec.seed(seed_strs, seed_lens, seed_k);
  try {
    auto res = codec.decode(data, size, max_output);
    *out = static_cast<uint8_t*>(std::malloc(res.size() ? res.size() : 1));
    std::memcpy(*out, res.data(), res.size());
    *out_size = res.size();
    return 0;
  } catch (const std::length_error&) {
    return 2;
  } catch (const std::exception&) {
    return 1;
  }
}

// Warm-started variants (container-v2 model warm-start): seeds plus a
// tape of seed indices (-1 = reset) replayed through Codec::warm_start
// before coding.  Same return contract as the seeded variants.
int x3h_encode_warm(const uint8_t* data, size_t size, int max_match_count,
                    long window, long factor1, long factor2, int nl_remap,
                    const uint8_t* seed_strs, const int32_t* seed_lens,
                    size_t seed_k, const int32_t* tape, size_t tape_len,
                    uint8_t** out, size_t* out_size) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  codec.seed(seed_strs, seed_lens, seed_k);
  try {
    codec.warm_start(tape, tape_len);
  } catch (const std::exception&) {
    return 1;
  }
  auto res = codec.encode(data, size);
  *out = static_cast<uint8_t*>(std::malloc(res.size() ? res.size() : 1));
  std::memcpy(*out, res.data(), res.size());
  *out_size = res.size();
  return 0;
}

int x3h_decode_warm(const uint8_t* data, size_t size, size_t max_output,
                    const uint8_t* seed_strs, const int32_t* seed_lens,
                    size_t seed_k, const int32_t* tape, size_t tape_len,
                    uint8_t** out, size_t* out_size) {
  x3host::Params p;
  x3host::Codec codec(p);
  codec.seed(seed_strs, seed_lens, seed_k);
  try {
    codec.warm_start(tape, tape_len);
    auto res = codec.decode(data, size, max_output);
    *out = static_cast<uint8_t*>(std::malloc(res.size() ? res.size() : 1));
    std::memcpy(*out, res.data(), res.size());
    *out_size = res.size();
    return 0;
  } catch (const std::length_error&) {
    return 2;
  } catch (const std::exception&) {
    return 1;
  }
}

// As x3h_train_ranked, but also emits the warm-up tape: one i32 per
// training event — the kept-seed index of the hit tag, or -1 for E_NEW /
// unkept tags.  Writes at most tape_cap entries (the head of the
// sequence); *tape_len gets the count written.  Returns seed count.
size_t x3h_train_tape(const uint8_t* data, size_t size,
                      int max_match_count, long window, long factor1,
                      long factor2, int nl_remap, uint8_t* strs,
                      int32_t* lens, size_t k, int32_t* tape,
                      size_t tape_cap, size_t* tape_len) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  std::vector<long> raw;
  codec.record_tape(&raw);
  codec.encode(data, size);
  size_t n = codec.dump_dict(strs, lens, k, 1);
  auto kept = codec.dump_order(n, 1);
  std::vector<int32_t> mapped;
  x3host::Codec::map_tape(raw, kept, &mapped);
  size_t tn = mapped.size() < tape_cap ? mapped.size() : tape_cap;
  for (size_t i = 0; i < tn; ++i) tape[i] = mapped[i];
  *tape_len = tn;
  return n;
}

void x3h_free(uint8_t* ptr) { std::free(ptr); }

// Measure state growth after encoding: out = {dict, pairs, ctx0_hub,
// ctx0_max_nonhub, ctx1_hub, ctx1_max_nonhub}.
void x3h_measure(const uint8_t* data, size_t size, int max_match_count,
                 long window, long factor1, long factor2, int nl_remap,
                 long small_cap, int64_t* out) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  codec.encode(data, size);
  codec.measure(size_t(small_cap), out);
}

// Train a seed dictionary: encode a sample and dump the first k dictionary
// fragments (insertion order).  Returns the number written.
size_t x3h_train(const uint8_t* data, size_t size, int max_match_count,
                 long window, long factor1, long factor2, int nl_remap,
                 uint8_t* strs, int32_t* lens, size_t k) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  codec.encode(data, size);
  return codec.dump_dict(strs, lens, k);
}

// As x3h_train, but seeds come out ordered by descending use count on the
// sample (hot fragments land at low MTF ranks in every seeded block).
size_t x3h_train_ranked(const uint8_t* data, size_t size,
                        int max_match_count, long window, long factor1,
                        long factor2, int nl_remap, uint8_t* strs,
                        int32_t* lens, size_t k) {
  x3host::Params p;
  p.max_match_count = max_match_count;
  p.window = window;
  p.factor1 = factor1;
  p.factor2 = factor2;
  p.nl_remap = nl_remap;
  x3host::Codec codec(p);
  codec.encode(data, size);
  return codec.dump_dict(strs, lens, k, 1);
}

}  // extern "C"
