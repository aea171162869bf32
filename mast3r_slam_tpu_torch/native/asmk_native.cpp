// Native ASMK inverted-file engine for retrieval loop closure.
//
// A copy of mast3r_slam_tpu/native/asmk_native.cpp, kept here so that the
// port needs nothing of the JAX package. It is the C++ form of the ASMK
// library's Cython Hamming kernels (binarize_and_pack_2D,
// hamming_cdist_packed) and of its numpy inverted file, exposed to Python
// through a plain C ABI for ctypes.
//
// Scoring (binary kernel, idf disabled):
//   sim        = 1 - 2 * hamming(q, v) / bits
//   contrib    = sim^alpha if sim >= sim_thresh, weighted 1/sqrt(norm[img])
//   score(img) = sum(contrib) / sqrt(#query words)
//
// The hot loop is a popcount over packed 64-bit words: builtin popcountll
// compiles to the POPCNT instruction.
//
// Build: g++ -O3 -std=c++17 -fPIC -mpopcnt -shared, done at first use by
// mast3r_slam_tpu_torch/native/__init__.py into build/torch_kernels/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct PostingList {
  std::vector<uint64_t> vecs;   // n * words_per_vec packed descriptors
  std::vector<int64_t> imids;
  int64_t count = 0;
};

struct IVF {
  int64_t n_words;
  int64_t dim;            // descriptor bits
  int64_t wpv;            // 64-bit words per packed vector
  std::vector<PostingList> lists;
  std::vector<double> norm_factor;
  int64_t n_images = 0;
};

inline int64_t words_per_vec(int64_t dim) { return (dim + 63) / 64; }

}  // namespace

extern "C" {

// Sign-binarize and pack rows of (n, dim) floats into (n, ceil(dim/64))
// uint64 words. Bit i of a word is set iff value > 0.
void asmk_binarize_pack(const float* des, int64_t n, int64_t dim,
                        uint64_t* out) {
  const int64_t w = words_per_vec(dim);
  std::memset(out, 0, sizeof(uint64_t) * n * w);
  for (int64_t r = 0; r < n; ++r) {
    const float* row = des + r * dim;
    uint64_t* orow = out + r * w;
    for (int64_t b = 0; b < dim; ++b) {
      if (row[b] > 0.0f) orow[b >> 6] |= (uint64_t(1) << (b & 63));
    }
  }
}

// Normalized Hamming distances between packed rows: (na, nb) float32 out.
void asmk_hamming_cdist(const uint64_t* a, int64_t na, const uint64_t* b,
                        int64_t nb, int64_t dim, float* out) {
  const int64_t w = words_per_vec(dim);
  const float inv = 1.0f / float(dim);
  for (int64_t i = 0; i < na; ++i) {
    const uint64_t* ra = a + i * w;
    for (int64_t j = 0; j < nb; ++j) {
      const uint64_t* rb = b + j * w;
      int64_t d = 0;
      for (int64_t k = 0; k < w; ++k)
        d += __builtin_popcountll(ra[k] ^ rb[k]);
      out[i * nb + j] = float(d) * inv;
    }
  }
}

void* asmk_ivf_create(int64_t n_words, int64_t dim) {
  IVF* ivf = new IVF();
  ivf->n_words = n_words;
  ivf->dim = dim;
  ivf->wpv = words_per_vec(dim);
  ivf->lists.resize(n_words);
  return ivf;
}

void asmk_ivf_destroy(void* handle) { delete static_cast<IVF*>(handle); }

int64_t asmk_ivf_n_images(void* handle) {
  return static_cast<IVF*>(handle)->n_images;
}

// Add n aggregated packed descriptors with their word ids for image imid.
void asmk_ivf_add(void* handle, const uint64_t* packed, const int64_t* words,
                  int64_t n, int64_t imid) {
  IVF* ivf = static_cast<IVF*>(handle);
  if (imid + 1 > (int64_t)ivf->norm_factor.size())
    ivf->norm_factor.resize(imid + 1, 0.0);
  if (imid + 1 > ivf->n_images) ivf->n_images = imid + 1;
  for (int64_t i = 0; i < n; ++i) {
    PostingList& pl = ivf->lists[words[i]];
    pl.vecs.insert(pl.vecs.end(), packed + i * ivf->wpv,
                   packed + (i + 1) * ivf->wpv);
    pl.imids.push_back(imid);
    pl.count++;
    ivf->norm_factor[imid] += 1.0;
  }
}

// --- serialization (a snapshot restores in one call; the numpy IVF has
// state_dict/from_state for the same purpose) --

// Total posting entries across all words (rows of the export arrays).
int64_t asmk_ivf_n_entries(void* handle) {
  IVF* ivf = static_cast<IVF*>(handle);
  int64_t n = 0;
  for (const auto& pl : ivf->lists) n += pl.count;
  return n;
}

// Dump every posting entry: packed vecs (n_entries * wpv u64), word ids and
// image ids (n_entries i64). Order: by word, then insertion order — the
// exact append order asmk_ivf_import replays.
void asmk_ivf_export(void* handle, uint64_t* vecs_out, int64_t* words_out,
                     int64_t* imids_out) {
  IVF* ivf = static_cast<IVF*>(handle);
  int64_t r = 0;
  for (int64_t w = 0; w < ivf->n_words; ++w) {
    const PostingList& pl = ivf->lists[w];
    for (int64_t j = 0; j < pl.count; ++j, ++r) {
      std::memcpy(vecs_out + r * ivf->wpv, pl.vecs.data() + j * ivf->wpv,
                  sizeof(uint64_t) * ivf->wpv);
      words_out[r] = w;
      imids_out[r] = pl.imids[j];
    }
  }
}

// Bulk append with PER-ENTRY image ids (asmk_ivf_add takes one imid for the
// whole batch); norm_factor accumulates exactly as the original adds did.
void asmk_ivf_import(void* handle, const uint64_t* packed,
                     const int64_t* words, const int64_t* imids, int64_t n) {
  IVF* ivf = static_cast<IVF*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t imid = imids[i];
    if (imid + 1 > (int64_t)ivf->norm_factor.size())
      ivf->norm_factor.resize(imid + 1, 0.0);
    if (imid + 1 > ivf->n_images) ivf->n_images = imid + 1;
    PostingList& pl = ivf->lists[words[i]];
    pl.vecs.insert(pl.vecs.end(), packed + i * ivf->wpv,
                   packed + (i + 1) * ivf->wpv);
    pl.imids.push_back(imid);
    pl.count++;
    ivf->norm_factor[imid] += 1.0;
  }
}

// Score a query (n aggregated packed descriptors + word ids) against the
// database; writes scores for images [0, n_images) into scores_out.
void asmk_ivf_search(void* handle, const uint64_t* packed,
                     const int64_t* words, int64_t n, double alpha,
                     double sim_thresh, float* scores_out) {
  IVF* ivf = static_cast<IVF*>(handle);
  const int64_t wpv = ivf->wpv;
  const double inv_bits = 1.0 / double(ivf->dim);
  std::vector<double> scores(ivf->n_images, 0.0);
  double q_norm = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    q_norm += 1.0;
    const PostingList& pl = ivf->lists[words[i]];
    if (pl.count == 0) continue;
    const uint64_t* q = packed + i * wpv;
    for (int64_t j = 0; j < pl.count; ++j) {
      const uint64_t* v = pl.vecs.data() + j * wpv;
      int64_t d = 0;
      for (int64_t k = 0; k < wpv; ++k)
        d += __builtin_popcountll(q[k] ^ v[k]);
      const double sim = 1.0 - 2.0 * double(d) * inv_bits;
      if (sim >= sim_thresh) {
        const int64_t imid = pl.imids[j];
        scores[imid] += std::pow(sim, alpha) /
                        std::sqrt(ivf->norm_factor[imid]);
      }
    }
  }
  const double qn = q_norm > 0 ? 1.0 / std::sqrt(q_norm) : 0.0;
  for (int64_t i = 0; i < ivf->n_images; ++i)
    scores_out[i] = float(scores[i] * qn);
}

}  // extern "C"
