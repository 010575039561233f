// C++ inference client for exported MREC1 models: the port's copy of
// mindrec_tpu/serving/infer_client.cc, unchanged in what it computes.
//
// It loads a model written by mindrec_tpu_torch/io/export.py, runs the
// forward pass of the CTR model zoo (wide_deep / deepfm / dcn: gather ->
// FM or cross net -> MLP) on the host CPU over one batch of binary inputs
// and writes the probabilities and its latency.  It is built with g++ at
// first use by mindrec_tpu_torch/serving/client.py.
//
// Usage:
//   infer_client <model.mrec> <ids.bin> <wts.bin> <batch> <fields> <out.txt>
// ids.bin: int32[batch*fields], wts.bin: float32[batch*fields]
// Output: one probability per line + "avg latency: X ms" to stderr.

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <string>
#include <vector>

namespace {

struct Tensor {
  std::vector<uint64_t> dims;
  std::vector<float> f32;
  std::vector<int32_t> i32;
  uint64_t numel() const {
    uint64_t n = 1;
    for (auto d : dims) n *= d;
    return n;
  }
};

struct Model {
  uint32_t kind = 0;
  std::map<std::string, Tensor> tensors;
};

bool LoadModel(const std::string& path, Model* m) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[5];
  f.read(magic, 5);
  if (std::memcmp(magic, "MREC1", 5) != 0) return false;
  uint32_t n = 0;
  f.read(reinterpret_cast<char*>(&m->kind), 4);
  f.read(reinterpret_cast<char*>(&n), 4);
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t nlen = 0, dt = 0, ndim = 0;
    f.read(reinterpret_cast<char*>(&nlen), 4);
    std::string name(nlen, '\0');
    f.read(name.data(), nlen);
    f.read(reinterpret_cast<char*>(&dt), 4);
    f.read(reinterpret_cast<char*>(&ndim), 4);
    Tensor t;
    t.dims.resize(ndim);
    for (uint32_t d = 0; d < ndim; ++d)
      f.read(reinterpret_cast<char*>(&t.dims[d]), 8);
    uint64_t count = t.numel();
    if (dt == 0) {
      t.f32.resize(count);
      f.read(reinterpret_cast<char*>(t.f32.data()), count * 4);
    } else {
      t.i32.resize(count);
      f.read(reinterpret_cast<char*>(t.i32.data()), count * 4);
    }
    m->tensors.emplace(std::move(name), std::move(t));
  }
  return true;
}

// y = relu(x @ W + b) applied in sequence; final layer no activation.
void MLP(const std::vector<const Tensor*>& ws,
         const std::vector<const Tensor*>& bs, std::vector<float>& x,
         uint64_t batch) {
  for (size_t l = 0; l < ws.size(); ++l) {
    const uint64_t in = ws[l]->dims[0], out = ws[l]->dims[1];
    std::vector<float> y(batch * out, 0.f);
    for (uint64_t b = 0; b < batch; ++b) {
      const float* xr = &x[b * in];
      float* yr = &y[b * out];
      for (uint64_t o = 0; o < out; ++o) yr[o] = bs[l]->f32[o];
      for (uint64_t i = 0; i < in; ++i) {
        const float xv = xr[i];
        if (xv == 0.f) continue;
        const float* wrow = &ws[l]->f32[i * out];
        for (uint64_t o = 0; o < out; ++o) yr[o] += xv * wrow[o];
      }
      if (l + 1 < ws.size())
        for (uint64_t o = 0; o < out; ++o) yr[o] = yr[o] > 0.f ? yr[o] : 0.f;
    }
    x.swap(y);
  }
}

std::vector<const Tensor*> Collect(const Model& m, const char* prefix,
                                   const char* suffix) {
  std::vector<const Tensor*> out;
  for (int i = 0; i < 64; ++i) {
    auto it = m.tensors.find(std::string(prefix) + std::to_string(i) + suffix);
    if (it == m.tensors.end()) break;
    out.push_back(&it->second);
  }
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 7) {
    std::fprintf(stderr,
                 "usage: %s <model.mrec> <ids.bin> <wts.bin> <batch> <fields> "
                 "<out.txt>\n",
                 argv[0]);
    return 1;
  }
  Model m;
  if (!LoadModel(argv[1], &m)) {
    std::fprintf(stderr, "failed to load %s\n", argv[1]);
    return 1;
  }
  const uint64_t batch = std::strtoull(argv[4], nullptr, 10);
  const uint64_t fields = std::strtoull(argv[5], nullptr, 10);

  std::vector<int32_t> ids(batch * fields);
  std::vector<float> wts(batch * fields);
  {
    std::ifstream fi(argv[2], std::ios::binary), fw(argv[3], std::ios::binary);
    fi.read(reinterpret_cast<char*>(ids.data()), ids.size() * 4);
    fw.read(reinterpret_cast<char*>(wts.data()), wts.size() * 4);
  }

  const auto t0 = std::chrono::steady_clock::now();
  std::vector<float> logits(batch, 0.f);

  if (m.kind == 0 || m.kind == 1) {  // wide_deep / deepfm share layout shape
    const bool deepfm = m.kind == 1;
    const Tensor& wide_tab =
        m.tensors.at(deepfm ? "linear/table" : "wide/table");
    const Tensor& deep_tab = m.tensors.at(deepfm ? "fm/table" : "deep/table");
    const uint64_t dim = deep_tab.dims[1];
    auto ws = Collect(m, deepfm ? "mlp/" : "deep/mlp/", "/w");
    auto bs = Collect(m, deepfm ? "mlp/" : "deep/mlp/", "/b");
    const Tensor* bias =
        deepfm ? nullptr : &m.tensors.at("wide/bias");

    std::vector<float> deep_in(batch * fields * dim);
    for (uint64_t b = 0; b < batch; ++b) {
      float wide = bias ? bias->f32[0] : 0.f;
      float fm = 0.f;
      std::vector<float> sum(dim, 0.f), sumsq(dim, 0.f);
      for (uint64_t fidx = 0; fidx < fields; ++fidx) {
        const int32_t id = ids[b * fields + fidx];
        const float wt = wts[b * fields + fidx];
        wide += wide_tab.f32[id] * wt;
        const float* v = &deep_tab.f32[(uint64_t)id * dim];
        float* dst = &deep_in[(b * fields + fidx) * dim];
        for (uint64_t d = 0; d < dim; ++d) {
          const float x = v[d] * wt;
          dst[d] = x;
          sum[d] += x;
          sumsq[d] += x * x;
        }
      }
      if (deepfm)
        for (uint64_t d = 0; d < dim; ++d)
          fm += 0.5f * (sum[d] * sum[d] - sumsq[d]);
      logits[b] = wide + fm;
    }
    MLP(ws, bs, deep_in, batch);
    for (uint64_t b = 0; b < batch; ++b) logits[b] += deep_in[b];
  } else if (m.kind == 2) {  // dcn
    const Tensor& tab = m.tensors.at("emb/table");
    const uint64_t dim = tab.dims[1];
    auto ws = Collect(m, "mlp/", "/w");
    auto bs = Collect(m, "mlp/", "/b");
    auto cw = Collect(m, "cross/", "/w");
    auto cb = Collect(m, "cross/", "/b");
    const Tensor& fw = m.tensors.at("final/w");
    const Tensor& fb = m.tensors.at("final/b");
    const uint64_t d0 = fields * dim;

    std::vector<float> x0(batch * d0);
    for (uint64_t b = 0; b < batch; ++b)
      for (uint64_t fidx = 0; fidx < fields; ++fidx) {
        const int32_t id = ids[b * fields + fidx];
        const float wt = wts[b * fields + fidx];
        const float* v = &tab.f32[(uint64_t)id * dim];
        for (uint64_t d = 0; d < dim; ++d)
          x0[b * d0 + fidx * dim + d] = v[d] * wt;
      }
    // deep tower: every layer uses relu (reference DCN DenseLayer)
    std::vector<float> deep = x0;
    for (size_t l = 0; l < ws.size(); ++l) {
      const uint64_t in = ws[l]->dims[0], out = ws[l]->dims[1];
      std::vector<float> y(batch * out, 0.f);
      for (uint64_t b = 0; b < batch; ++b) {
        float* yr = &y[b * out];
        for (uint64_t o = 0; o < out; ++o) yr[o] = bs[l]->f32[o];
        for (uint64_t i = 0; i < in; ++i) {
          const float xv = deep[b * in + i];
          if (xv == 0.f) continue;
          const float* wrow = &ws[l]->f32[i * out];
          for (uint64_t o = 0; o < out; ++o) yr[o] += xv * wrow[o];
        }
        for (uint64_t o = 0; o < out; ++o) yr[o] = yr[o] > 0.f ? yr[o] : 0.f;
      }
      deep.swap(y);
    }
    // cross tower
    std::vector<float> xc = x0;
    for (size_t l = 0; l < cw.size(); ++l) {
      for (uint64_t b = 0; b < batch; ++b) {
        float dot = 0.f;
        for (uint64_t d = 0; d < d0; ++d) dot += xc[b * d0 + d] * cw[l]->f32[d];
        for (uint64_t d = 0; d < d0; ++d)
          xc[b * d0 + d] = x0[b * d0 + d] * dot + cb[l]->f32[d] + xc[b * d0 + d];
      }
    }
    // final dense over concat(deep, cross)
    const uint64_t dd = ws.empty() ? 0 : ws.back()->dims[1];
    for (uint64_t b = 0; b < batch; ++b) {
      float acc = fb.f32[0];
      for (uint64_t i = 0; i < dd; ++i) acc += deep[b * dd + i] * fw.f32[i];
      for (uint64_t d = 0; d < d0; ++d)
        acc += xc[b * d0 + d] * fw.f32[dd + d];
      logits[b] = acc;
    }
  } else {
    std::fprintf(stderr, "unsupported model kind %u\n", m.kind);
    return 1;
  }

  const auto t1 = std::chrono::steady_clock::now();
  const double ms =
      std::chrono::duration_cast<std::chrono::microseconds>(t1 - t0).count() /
      1000.0;

  std::ofstream out(argv[6]);
  for (uint64_t b = 0; b < batch; ++b)
    out << 1.0 / (1.0 + std::exp(-logits[b])) << "\n";
  std::fprintf(stderr, "avg latency: %.3f ms (%llu samples)\n", ms,
               (unsigned long long)batch);
  return 0;
}
