// Remote embedding table server: the parameter-server role of PS mode.
// A copy of the JAX package's native/table_server.cc that speaks its wire byte
// for byte and gives the same initial rows bit for bit; built by g++ at
// first use (ops/remote.py:server_binary_path) into
// mindrec_tpu_torch/_build/table_server-<hash>/.
//
// One process serves any number of named tables over a small binary TCP
// protocol.  Per table:
//   * rows materialise lazily on first READ with a deterministic per-id
//     initialiser (splitmix64(id ^ seed) -> bias + std * N(0, 1)), so a
//     10^10-row virtual vocab costs only the touched rows;
//   * a RAM arena holds the first `ram_bytes / row_bytes` rows; rows
//     beyond the cap spill to an append-allocated file (the RAM-cap knob:
//     --ram-mb, else env MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE in GB),
//     read and written through a shared mapping of it (the reference
//     seeks and reads or writes each row through stdio, a system call or
//     two per spilled row);
//   * WRITE upserts full rows (the worker evicts dirty cache rows here).
//
// Two changes against the reference:
//   * the spill file of a table is private to this process: its name
//     carries the listen port, the pid and a per-process table number,
//     and it is unlinked once open (the reference names it
//     <spill_dir>/mrec_spill_<table>.bin, opened "w+b", so servers that
//     share a spill directory overwrite each other's rows);
//   * the hash store is this directory's hashstore_impl.h, whose bucket
//     table grows (the reference's fills with pending keys).
//   --ram-mb wins over the env var (the reference lets the env var win);
//   the default spill directory is $TMPDIR, else /tmp.
//
// Protocol (little-endian), one connection = one table:
//   handshake: client "MREC" u32 dim  char name[32]  f32 init_std
//              f32 init_bias  u64 seed     (init row = bias + std*N(0,1))
//              server "MRSV" u32 dim            (dim echoed; 0 = reject)
//   frames:    u8 op, u32 n, payload
//     op 1 READ   : n*i64 ids            -> n*dim f32
//     op 2 WRITE  : n*i64 ids, n*dim f32 -> u8 1
//     op 3 FLUSH  :                      -> u8 1
//     op 4 STATS  :                      -> u64 ram_rows, u64 ssd_rows
//     op 5 SHUT   :                      -> u8 1 (process exits)
//
// Hash-store connections (the distributed id -> slot map of the dynamic
// regime, sharded across servers by key hash) handshake with "MRHS":
//   client "MRHS" char name[32] i64 capacity i64 slot_base i64 permit
//          i64 evict; server "MRSV" u32 1
//   frames: u8 op, u32 n, payload
//     op 10 HLOOKUP: u8 force, n*i64 keys -> n*i64 slots (slot_base
//                    offset applied; -1 = not admitted / full); n may be
//                    0: the store's step clock still advances
//     op 11 HEVICT :                      -> u32 m, m*i64 freed slots
//     op 12 HITEMS :                      -> u32 m, m*i64 keys, m*i64 slots
//     op 13 HERASE : n*i64 keys           -> u8 1
//     op 14 HSIZE  :                      -> u64 admitted keys
// A named hash store is created on its first handshake (capacity,
// permit and evict fixed then); every client shares it.
//
// Run: table_server --port 18900 [--ram-mb 64] [--spill-dir DIR]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <fcntl.h>
#include <netinet/tcp.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "hashstore_impl.h"

namespace {

uint64_t Splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Deterministic N(0,1) pair from a 64-bit state (Box-Muller).
void Normal2(uint64_t s, float* a, float* b) {
  uint64_t u1 = Splitmix64(s), u2 = Splitmix64(s + 1);
  double x = (double)(u1 >> 11) * (1.0 / 9007199254740992.0);  // (0,1)
  double y = (double)(u2 >> 11) * (1.0 / 9007199254740992.0);
  if (x < 1e-300) x = 1e-300;
  double r = std::sqrt(-2.0 * std::log(x));
  *a = (float)(r * std::cos(2.0 * M_PI * y));
  *b = (float)(r * std::sin(2.0 * M_PI * y));
}

constexpr size_t kInitThreads = 4;  // per request that draws many rows

class Table {
 public:
  Table(uint32_t dim, float init_std, float init_bias, uint64_t seed,
        int64_t ram_rows, const std::string& spill_path)
      : dim_(dim), init_std_(init_std), init_bias_(init_bias), seed_(seed),
        ram_rows_(ram_rows), spill_path_(spill_path) {}

  ~Table() {
    if (map_) ::munmap(map_, map_rows_ * row_bytes());
    if (fd_ >= 0) ::close(fd_);
  }

  uint32_t dim() const { return dim_; }

  // Rows of `ids` into `out`.  The rows of ids seen for the first time
  // are initialised, then stored in request order, so RAM slots and
  // spill rows are allocated as one id at a time would allocate them; a
  // repeated new id reads its first position's row.
  void Read(const int64_t* ids, uint32_t n, float* out) {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<uint32_t> fresh;                      // first positions
    std::unordered_map<int64_t, uint32_t> first;      // new id -> position
    std::vector<std::pair<uint32_t, uint32_t>> dups;  // (position, first)
    for (uint32_t i = 0; i < n; ++i) {
      if (Lookup(ids[i], out + (size_t)i * dim_)) continue;
      auto ins = first.emplace(ids[i], i);
      if (ins.second) fresh.push_back(i);
      else dups.emplace_back(i, ins.first->second);
    }
    InitRows(ids, fresh, out);
    for (uint32_t i : fresh) Store(ids[i], out + (size_t)i * dim_);
    for (auto& d : dups)
      std::memcpy(out + (size_t)d.first * dim_, out + (size_t)d.second * dim_,
                  row_bytes());
  }

  void Write(const int64_t* ids, uint32_t n, const float* rows) {
    std::lock_guard<std::mutex> g(mu_);
    for (uint32_t i = 0; i < n; ++i) Store(ids[i], rows + (size_t)i * dim_);
  }

  // The spilled rows live in a shared mapping of the file, so a stored
  // row is already the OS's (as the reference's fflush leaves it).
  void Flush() {}

  void Stats(uint64_t* ram, uint64_t* ssd) {
    std::lock_guard<std::mutex> g(mu_);
    *ram = arena_.size() / dim_;
    *ssd = ssd_index_.size();
  }

 private:
  void InitRow(int64_t id, float* out) {
    if (init_std_ == 0.0f) {
      for (uint32_t d = 0; d < dim_; ++d) out[d] = init_bias_;
      return;
    }
    uint64_t s = Splitmix64((uint64_t)id ^ seed_);
    for (uint32_t d = 0; d < dim_; d += 2) {
      float a, b;
      Normal2(s + d, &a, &b);
      out[d] = init_bias_ + a * init_std_;
      if (d + 1 < dim_) out[d + 1] = init_bias_ + b * init_std_;
    }
  }

  size_t row_bytes() const { return (size_t)dim_ * 4; }

  // The spill file's row `frow`, the file grown (doubled, at least 4096
  // rows) and remapped first where it is too short.  The file is private
  // to this process: unlinked once open, its open handle keeps the data,
  // and no file outlives the server however it ends.
  float* SpillRow(uint64_t frow) {
    if (fd_ < 0) {
      fd_ = ::open(spill_path_.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0600);
      if (fd_ < 0) {
        std::fprintf(stderr, "table_server: cannot open spill %s\n",
                     spill_path_.c_str());
        std::abort();
      }
      ::unlink(spill_path_.c_str());
    }
    if (frow >= map_rows_) {
      uint64_t rows = map_rows_ ? map_rows_ : 4096;
      while (rows <= frow) rows *= 2;
      if (map_) ::munmap(map_, map_rows_ * row_bytes());
      if (::ftruncate(fd_, (off_t)(rows * row_bytes())) != 0) std::abort();
      void* m = ::mmap(nullptr, rows * row_bytes(), PROT_READ | PROT_WRITE,
                       MAP_SHARED, fd_, 0);
      if (m == MAP_FAILED) std::abort();
      map_ = (float*)m;
      map_rows_ = rows;
    }
    return map_ + frow * dim_;
  }

  // The stored row of `id` into `out`; false if it has none yet.
  bool Lookup(int64_t id, float* out) {
    auto it = ram_index_.find(id);
    if (it != ram_index_.end()) {
      std::memcpy(out, &arena_[(size_t)it->second * dim_], row_bytes());
      return true;
    }
    auto st = ssd_index_.find(id);
    if (st != ssd_index_.end()) {
      std::memcpy(out, SpillRow(st->second), row_bytes());
      return true;
    }
    return false;
  }

  // InitRow for the rows at `pos`; the random draws (a Box-Muller pair per
  // two floats) run on several threads when there are many rows.
  void InitRows(const int64_t* ids, const std::vector<uint32_t>& pos,
                float* out) {
    auto run = [&](size_t lo, size_t hi) {
      for (size_t k = lo; k < hi; ++k)
        InitRow(ids[pos[k]], out + (size_t)pos[k] * dim_);
    };
    size_t n = pos.size();
    size_t t = init_std_ == 0.0f || n < 4096
                   ? 1 : std::min<size_t>(kInitThreads, n / 2048);
    std::vector<std::thread> pool;
    for (size_t w = 1; w < t; ++w)
      pool.emplace_back(run, n * w / t, n * (w + 1) / t);
    run(0, n / t);
    for (auto& th : pool) th.join();
  }

  void Store(int64_t id, const float* row) {
    auto it = ram_index_.find(id);
    if (it != ram_index_.end()) {
      std::memcpy(&arena_[(size_t)it->second * dim_], row,
                  sizeof(float) * dim_);
      return;
    }
    auto st = ssd_index_.find(id);
    if (st == ssd_index_.end() && (int64_t)(ram_index_.size()) < ram_rows_) {
      uint32_t slot = (uint32_t)ram_index_.size();
      ram_index_.emplace(id, slot);
      arena_.resize((size_t)(slot + 1) * dim_);
      std::memcpy(&arena_[(size_t)slot * dim_], row, sizeof(float) * dim_);
      return;
    }
    uint64_t frow;
    if (st != ssd_index_.end()) {
      frow = st->second;
    } else {
      frow = ssd_rows_++;
      ssd_index_.emplace(id, frow);
    }
    std::memcpy(SpillRow(frow), row, row_bytes());
  }

  std::mutex mu_;
  uint32_t dim_;
  float init_std_;
  float init_bias_;
  uint64_t seed_;
  int64_t ram_rows_;
  std::string spill_path_;
  std::unordered_map<int64_t, uint32_t> ram_index_;
  std::vector<float> arena_;
  std::unordered_map<int64_t, uint64_t> ssd_index_;
  uint64_t ssd_rows_ = 0;
  int fd_ = -1;
  float* map_ = nullptr;
  uint64_t map_rows_ = 0;
};

// One named hash store shard (slot_base offsets its local slot range
// into the client's global arena slot space).
struct HashShard {
  mindrec::HashStore* store;
  int64_t slot_base;
  std::mutex mu;
};

std::mutex g_hash_mu;
std::unordered_map<std::string, HashShard*> g_hash;

bool ReadAll(int fd, void* buf, size_t n);
bool WriteAll(int fd, const void* buf, size_t n);

// Serves one hash-store connection (magic already consumed by Serve).
void ServeHash(int fd) {
  char name[32];
  int64_t capacity, slot_base, permit, evict;
  if (!ReadAll(fd, name, 32) || !ReadAll(fd, &capacity, 8) ||
      !ReadAll(fd, &slot_base, 8) || !ReadAll(fd, &permit, 8) ||
      !ReadAll(fd, &evict, 8)) {
    ::close(fd);
    return;
  }
  std::string hname(name, strnlen(name, 32));
  HashShard* sh = nullptr;
  {
    std::lock_guard<std::mutex> g(g_hash_mu);
    auto it = g_hash.find(hname);
    if (it == g_hash.end()) {
      sh = new HashShard{new mindrec::HashStore(capacity, permit, evict),
                         slot_base, {}};
      g_hash.emplace(hname, sh);
    } else {
      sh = it->second;
    }
  }
  uint32_t ack = 1;
  if (!WriteAll(fd, "MRSV", 4) || !WriteAll(fd, &ack, 4)) {
    ::close(fd);
    return;
  }
  std::vector<int64_t> keys, slots;
  for (;;) {
    uint8_t op;
    uint32_t n;
    if (!ReadAll(fd, &op, 1) || !ReadAll(fd, &n, 4)) break;
    if (op == 10) {  // HLOOKUP
      uint8_t force;
      if (!ReadAll(fd, &force, 1)) break;
      keys.resize(n);
      slots.resize(n);
      if (!ReadAll(fd, keys.data(), (size_t)n * 8)) break;
      {
        std::lock_guard<std::mutex> g(sh->mu);
        sh->store->LookupOrInsert(keys.data(), n, slots.data(), force != 0);
      }
      for (uint32_t i = 0; i < n; ++i)
        if (slots[i] >= 0) slots[i] += sh->slot_base;
      if (!WriteAll(fd, slots.data(), (size_t)n * 8)) break;
    } else if (op == 11) {  // HEVICT
      std::vector<int64_t> freed;
      {
        std::lock_guard<std::mutex> g(sh->mu);
        freed.resize((size_t)sh->store->size());
        int64_t m = sh->store->Evict(freed.data());
        freed.resize((size_t)m);
      }
      for (auto& s : freed) s += sh->slot_base;
      uint32_t m = (uint32_t)freed.size();
      if (!WriteAll(fd, &m, 4)) break;
      if (m && !WriteAll(fd, freed.data(), (size_t)m * 8)) break;
    } else if (op == 12) {  // HITEMS
      std::vector<int64_t> ik, is;
      {
        std::lock_guard<std::mutex> g(sh->mu);
        ik.resize((size_t)sh->store->size());
        is.resize((size_t)sh->store->size());
        int64_t m = sh->store->Items(ik.data(), is.data());
        ik.resize((size_t)m);
        is.resize((size_t)m);
      }
      for (auto& s : is) s += sh->slot_base;
      uint32_t m = (uint32_t)ik.size();
      if (!WriteAll(fd, &m, 4)) break;
      if (m && (!WriteAll(fd, ik.data(), (size_t)m * 8) ||
                !WriteAll(fd, is.data(), (size_t)m * 8)))
        break;
    } else if (op == 13) {  // HERASE
      keys.resize(n);
      if (!ReadAll(fd, keys.data(), (size_t)n * 8)) break;
      {
        std::lock_guard<std::mutex> g(sh->mu);
        sh->store->Erase(keys.data(), n);
      }
      uint8_t ok = 1;
      if (!WriteAll(fd, &ok, 1)) break;
    } else if (op == 14) {  // HSIZE
      uint64_t m;
      {
        std::lock_guard<std::mutex> g(sh->mu);
        m = (uint64_t)sh->store->size();
      }
      if (!WriteAll(fd, &m, 8)) break;
    } else {
      break;
    }
  }
  ::close(fd);
}

std::mutex g_tables_mu;
std::unordered_map<std::string, Table*> g_tables;
int64_t g_ram_bytes = -1;  // per table; -1 = unlimited
std::string g_spill_dir;
int g_port = 0;

bool ReadAll(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool WriteAll(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

// <spill_dir>/mrec_spill_<port>_<pid>_<k>_<table>.bin, the table name's
// bytes other than [A-Za-z0-9._-] as '_' (k keeps names unique)
std::string SpillPath(const std::string& tname, size_t k) {
  std::string safe = tname;
  for (auto& c : safe)
    if (!(std::isalnum((unsigned char)c) || c == '.' || c == '_' || c == '-'))
      c = '_';
  return g_spill_dir + "/mrec_spill_" + std::to_string(g_port) + "_" +
         std::to_string((long long)::getpid()) + "_" + std::to_string(k) +
         "_" + safe + ".bin";
}

void Serve(int fd) {
  char magic[4];
  uint32_t dim;
  char name[32];
  float init_std, init_bias;
  uint64_t seed;
  if (!ReadAll(fd, magic, 4)) {
    ::close(fd);
    return;
  }
  if (std::memcmp(magic, "MRHS", 4) == 0) {
    ServeHash(fd);
    return;
  }
  if (std::memcmp(magic, "MREC", 4) != 0 ||
      !ReadAll(fd, &dim, 4) || !ReadAll(fd, name, 32) ||
      !ReadAll(fd, &init_std, 4) || !ReadAll(fd, &init_bias, 4) ||
      !ReadAll(fd, &seed, 8)) {
    ::close(fd);
    return;
  }
  std::string tname(name, strnlen(name, 32));
  Table* table = nullptr;
  {
    std::lock_guard<std::mutex> g(g_tables_mu);
    auto it = g_tables.find(tname);
    if (it == g_tables.end()) {
      int64_t ram_rows =
          g_ram_bytes < 0 ? INT64_MAX : g_ram_bytes / (int64_t)(dim * 4);
      if (ram_rows < 1) ram_rows = 1;
      table = new Table(dim, init_std, init_bias, seed, ram_rows,
                        SpillPath(tname, g_tables.size()));
      g_tables.emplace(tname, table);
    } else {
      table = it->second;
    }
  }
  uint32_t ack_dim = (table->dim() == dim) ? dim : 0;
  if (!WriteAll(fd, "MRSV", 4) || !WriteAll(fd, &ack_dim, 4) || !ack_dim) {
    ::close(fd);
    return;
  }

  std::vector<int64_t> ids;
  std::vector<float> rows;
  for (;;) {
    uint8_t op;
    uint32_t n;
    if (!ReadAll(fd, &op, 1) || !ReadAll(fd, &n, 4)) break;
    if (op == 1) {  // READ
      ids.resize(n);
      rows.resize((size_t)n * dim);
      if (!ReadAll(fd, ids.data(), (size_t)n * 8)) break;
      table->Read(ids.data(), n, rows.data());
      if (!WriteAll(fd, rows.data(), (size_t)n * dim * 4)) break;
    } else if (op == 2) {  // WRITE
      ids.resize(n);
      rows.resize((size_t)n * dim);
      if (!ReadAll(fd, ids.data(), (size_t)n * 8)) break;
      if (!ReadAll(fd, rows.data(), (size_t)n * dim * 4)) break;
      table->Write(ids.data(), n, rows.data());
      uint8_t ok = 1;
      if (!WriteAll(fd, &ok, 1)) break;
    } else if (op == 3) {  // FLUSH
      table->Flush();
      uint8_t ok = 1;
      if (!WriteAll(fd, &ok, 1)) break;
    } else if (op == 4) {  // STATS
      uint64_t ram, ssd;
      table->Stats(&ram, &ssd);
      if (!WriteAll(fd, &ram, 8) || !WriteAll(fd, &ssd, 8)) break;
    } else if (op == 5) {  // SHUTDOWN
      {
        std::lock_guard<std::mutex> g(g_tables_mu);
        for (auto& kv : g_tables) kv.second->Flush();
      }
      uint8_t ok = 1;
      WriteAll(fd, &ok, 1);
      ::close(fd);
      std::exit(0);  // accept() blocks; exiting is the clean stop
    } else {
      break;
    }
  }
  ::close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = 18900;
  int64_t cli_ram = -2;  // -2: not given
  const char* tmp = std::getenv("TMPDIR");
  g_spill_dir = (tmp && *tmp) ? tmp : "/tmp";
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--port" && i + 1 < argc) port = std::atoi(argv[++i]);
    else if (a == "--ram-mb" && i + 1 < argc)
      cli_ram = (int64_t)std::atoll(argv[++i]) * 1024 * 1024;
    else if (a == "--spill-dir" && i + 1 < argc) g_spill_dir = argv[++i];
  }
  if (cli_ram != -2) {
    g_ram_bytes = cli_ram;
  } else if (const char* e = std::getenv("MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE")) {
    // the reference's env knob, in gigabytes
    g_ram_bytes = (int64_t)(std::atof(e) * 1024.0 * 1024.0 * 1024.0);
  }
  g_port = port;

  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(lfd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    std::perror("table_server: bind");
    return 98;  // the port is taken (EADDRINUSE's number): pick another
  }
  ::listen(lfd, 64);
  std::fprintf(stderr, "table_server: listening on :%d (ram_bytes=%lld)\n",
               port, (long long)g_ram_bytes);
  std::fflush(stderr);

  for (;;) {
    int fd = ::accept(lfd, nullptr, nullptr);
    if (fd < 0) break;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(Serve, fd).detach();
  }
  ::close(lfd);
  return 0;
}
