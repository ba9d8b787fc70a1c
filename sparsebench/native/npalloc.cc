// Pooled numpy data allocator for lazy-memory virtualized hosts.
//
// Measured on this environment (firecracker-style VM with on-demand
// memory): first-touch of cold anonymous pages costs 7-75 MB/s through the
// VMM fault handler — write(2) to tmpfs is equally slow (in-kernel host
// page allocation), so nothing avoids the one-time cost. BUT tmpfs pages
// persist in the page cache after process exit, and a file-backed
// MAP_SHARED|MAP_POPULATE mapping of cached pages installs PTEs at
// ~53 GB/s with subsequent writes at ~4 GB/s.
//
// This extension therefore replaces numpy's data allocator
// (PyDataMem_SetHandler) with a pool that:
//
//   * serves allocations >= 1 MB from segments of a shared tmpfs file
//     (default /dev/shm/sb_npalloc_pool, override SB_POOL_FILE), mapped
//     MAP_SHARED|MAP_POPULATE — pages are warm once per boot, machine-wide;
//   * coordinates segment claims across processes through a header page
//     (flock + bump cursor + free-segment list); a process returns ALL its
//     segments on clean exit, so sequential benchmark processes recycle the
//     same warm memory;
//   * reuses freed blocks in-process first (no lock, no syscall);
//   * falls back to anonymous MAP_POPULATE mmaps (and then to plain
//     malloc) when the pool file is unavailable or full.
//
// The reference has no analog (bare-metal HPC hosts fault at memory
// speed); this is infrastructure a lazy-memory virtual host demands — the moral
// equivalent of the reference's aligned allocate() wrapper
// (src/allocate.c:12-36). Loaded at package import by _malloc_tuning.py.
// Disable with SB_NO_POOL_ALLOC=1.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_2_0_API_VERSION
#define NPY_TARGET_VERSION NPY_2_0_API_VERSION
#include <numpy/arrayobject.h>

#include <fcntl.h>
#include <malloc.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>

namespace {

constexpr size_t kPoolMin = 1u << 20;  // pool allocations >= 1 MB
constexpr size_t kRound = 2u << 20;    // segment granularity 2 MB
constexpr uint64_t kMagic = 0x5342504f4f4c3032ull;  // "SBPOOL02"
constexpr size_t kHeaderBytes = kRound;             // first segment = header
constexpr int kMaxFreeSegs = 4000;

// ------------------------------------------------------- shared pool header
struct PoolSeg {
  uint64_t off;
  uint64_t size;
};
struct PoolHeader {
  uint64_t magic;
  uint64_t cursor;     // next unclaimed byte (starts at kHeaderBytes)
  uint64_t file_size;  // bytes usable in the file
  uint32_t nfree;
  PoolSeg free_segs[kMaxFreeSegs];
};

int g_fd = -1;
PoolHeader* g_hdr = nullptr;  // mapped MAP_SHARED at install

struct Block {
  uint64_t off;   // file offset, or UINT64_MAX for anonymous
  size_t size;    // rounded size
};
// In-process caches (all under g_mu), deliberately LEAKED: pool_shutdown
// runs from .fini_array, i.e. AFTER __cxa_atexit static destructors, so
// ordinary globals would already be destroyed when it iterates g_blocks
// (observed: exit spun forever in _Rb_tree_increment walking the freed
// rb-tree once the pool held >1 segment). Allocator state must outlive
// every client, including exit-time frees — never destroy it.
std::mutex& g_mu = *new std::mutex;
std::multimap<size_t, void*>& g_free =
    *new std::multimap<size_t, void*>();        // freed blocks by size
std::map<void*, Block>& g_blocks =
    *new std::map<void*, Block>();              // every block ever claimed
std::map<void*, size_t>& g_live =
    *new std::map<void*, size_t>();             // live -> requested size
size_t g_cached = 0;
size_t g_cap = 24ull << 30;

size_t round_up(size_t n) { return (n + kRound - 1) & ~(kRound - 1); }

void hdr_lock() { if (g_fd >= 0) flock(g_fd, LOCK_EX); }
void hdr_unlock() { if (g_fd >= 0) flock(g_fd, LOCK_UN); }

// Claim a file segment of exactly `sz` bytes; UINT64_MAX on failure.
uint64_t claim_segment(size_t sz) {
  if (!g_hdr) return UINT64_MAX;
  hdr_lock();
  uint64_t off = UINT64_MAX;
  // exact-size match first, then smallest larger block (no splitting:
  // benchmark allocation sizes repeat, slack is cheap, simplicity wins)
  int best = -1;
  for (uint32_t i = 0; i < g_hdr->nfree; ++i) {
    const uint64_t s = g_hdr->free_segs[i].size;
    if (s == sz) { best = (int)i; break; }
    if (s > sz && (best < 0 || s < g_hdr->free_segs[best].size)) best = (int)i;
  }
  if (best >= 0) {
    off = g_hdr->free_segs[best].off;
    g_hdr->free_segs[best] = g_hdr->free_segs[--g_hdr->nfree];
  } else if (g_hdr->cursor + sz <= g_hdr->file_size) {
    off = g_hdr->cursor;
    g_hdr->cursor += sz;
  }
  hdr_unlock();
  return off;
}

void return_segment(uint64_t off, size_t sz) {
  if (!g_hdr || off == UINT64_MAX) return;
  hdr_lock();
  if (g_hdr->nfree < kMaxFreeSegs) {
    g_hdr->free_segs[g_hdr->nfree].off = off;
    g_hdr->free_segs[g_hdr->nfree].size = sz;
    ++g_hdr->nfree;
  }  // table full: leak the segment (pages stay warm for future claims
     // only via cursor reuse after reboot; bounded by file size)
  hdr_unlock();
}

// Allocate a pool block of rounded size `sz` (file segment if possible,
// anonymous MAP_POPULATE otherwise). Returns nullptr on total failure.
void* pool_grow(size_t sz) {
  uint64_t off = claim_segment(sz);
  void* p = MAP_FAILED;
  if (off != UINT64_MAX) {
    p = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, g_fd, (off_t)off);
    if (p == MAP_FAILED) return_segment(off, sz);
  }
  if (p == MAP_FAILED) {
    off = UINT64_MAX;
    p = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
             MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
    if (p == MAP_FAILED)
      p = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
               MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  g_blocks[p] = Block{off, sz};
  return p;
}

void* pool_alloc(size_t need, bool zero) {
  const size_t sz = round_up(need);
  void* p = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_free.find(sz);  // exact size class: no splitting
    if (it != g_free.end()) {
      p = it->second;
      g_free.erase(it);
      g_cached -= sz;
    }
  }
  if (!p) {
    p = pool_grow(sz);
    if (!p) return nullptr;
    // fresh anonymous mmap is zeroed; fresh FILE segment may hold garbage
    // from a previous process
    std::lock_guard<std::mutex> lk(g_mu);
    if (zero && g_blocks[p].off != UINT64_MAX) std::memset(p, 0, sz);
    g_live[p] = need;
    return p;
  }
  if (zero) std::memset(p, 0, sz);  // resident pages: memset is fast
  std::lock_guard<std::mutex> lk(g_mu);
  g_live[p] = need;
  return p;
}

void pool_release(void* p) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto bit = g_blocks.find(p);
  if (bit == g_blocks.end()) return;
  const size_t sz = bit->second.size;
  g_free.emplace(sz, p);
  g_cached += sz;
  while (g_cached > g_cap && !g_free.empty()) {
    auto last = std::prev(g_free.end());  // evict largest first
    void* vp = last->second;
    const size_t vsz = last->first;
    g_free.erase(last);
    g_cached -= vsz;
    auto b = g_blocks.find(vp);
    const uint64_t off = b->second.off;
    g_blocks.erase(b);
    munmap(vp, vsz);
    return_segment(off, vsz);  // pages stay warm in the page cache
  }
}

// On clean process exit, hand every claimed file segment back to the
// shared free list (our mappings die with the process; the tmpfs pages
// stay cached, so the next process re-claims them warm).
__attribute__((destructor)) void pool_shutdown() {
  if (!g_hdr) return;
  hdr_lock();
  for (auto& kv : g_blocks) {
    if (kv.second.off == UINT64_MAX) continue;
    if (g_hdr->nfree >= kMaxFreeSegs) break;
    g_hdr->free_segs[g_hdr->nfree].off = kv.second.off;
    g_hdr->free_segs[g_hdr->nfree].size = kv.second.size;
    ++g_hdr->nfree;
  }
  hdr_unlock();
}

// ----------------------------------------------------------- numpy handler
void* reg_malloc(void*, size_t size) {
  if (size >= kPoolMin) return pool_alloc(size, false);
  return malloc(size);
}

void* reg_calloc(void*, size_t nelem, size_t elsize) {
  const size_t size = nelem * elsize;
  if (elsize && size / elsize != nelem) return nullptr;
  if (size >= kPoolMin) return pool_alloc(size, true);
  return calloc(nelem, elsize);
}

void reg_free(void*, void* ptr, size_t size) {
  if (!ptr) return;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_live.find(ptr);
    if (it == g_live.end()) {
      // not pooled: requests < kPoolMin went to malloc
      free(ptr);
      return;
    }
    g_live.erase(it);
  }
  pool_release(ptr);
}

void* reg_realloc(void* ctx, void* ptr, size_t new_size) {
  if (!ptr) return reg_malloc(ctx, new_size);
  size_t old = 0;
  bool pooled = false;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_live.find(ptr);
    if (it != g_live.end()) {
      pooled = true;
      old = it->second;
    }
  }
  if (!pooled) {
    if (new_size < kPoolMin) return realloc(ptr, new_size);
    void* np_ = reg_malloc(ctx, new_size);
    if (!np_) return nullptr;
    // old malloc block (original request < kPoolMin): bound the copy by
    // its actual usable size
    size_t usable = malloc_usable_size(ptr);
    std::memcpy(np_, ptr, usable < new_size ? usable : new_size);
    free(ptr);
    return np_;
  }
  if (new_size >= kPoolMin && round_up(new_size) == round_up(old)) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_live[ptr] = new_size;
    return ptr;  // same 2MB class: reuse in place
  }
  if (new_size < kPoolMin) {
    // shrink out of the pool
    void* small = malloc(new_size);
    if (!small) return nullptr;
    std::memcpy(small, ptr, new_size);
    reg_free(ctx, ptr, old);
    return small;
  }
  void* np_ = reg_malloc(ctx, new_size);
  if (!np_) return nullptr;
  std::memcpy(np_, ptr, old < new_size ? old : new_size);
  reg_free(ctx, ptr, old);
  return np_;
}

PyDataMem_Handler g_handler = {
    "sb_pool_allocator",
    1,
    {nullptr, reg_malloc, reg_calloc, reg_realloc, reg_free},
};

bool open_pool_file() {
  const char* path = getenv("SB_POOL_FILE");
  if (path && std::strcmp(path, "anon") == 0) return false;
  if (!path) path = "/dev/shm/sb_npalloc_pool";
  int fd = open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return false;
  }
  uint64_t want = 16ull << 30;  // default pool file size
  const char* sz_env = getenv("SB_POOL_FILE_BYTES");
  if (sz_env) {
    const long long v = atoll(sz_env);
    if (v > (long long)(64u << 20)) want = (uint64_t)v;
  }
  uint64_t size = (uint64_t)st.st_size;
  if (size < kHeaderBytes + kRound) {
    if (ftruncate(fd, (off_t)want) != 0) {
      close(fd);
      return false;
    }
    size = want;
  }
  void* h = mmap(nullptr, kHeaderBytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                 fd, 0);
  if (h == MAP_FAILED) {
    close(fd);
    return false;
  }
  g_fd = fd;
  g_hdr = (PoolHeader*)h;
  flock(fd, LOCK_EX);
  if (g_hdr->magic != kMagic || g_hdr->cursor < kHeaderBytes ||
      g_hdr->cursor > size || g_hdr->nfree > kMaxFreeSegs) {
    std::memset(g_hdr, 0, sizeof(PoolHeader));
    g_hdr->magic = kMagic;
    g_hdr->cursor = kHeaderBytes;
    g_hdr->file_size = size;
  } else if (g_hdr->file_size < size) {
    g_hdr->file_size = size;  // file was grown (e.g. extra warming)
  }
  flock(fd, LOCK_UN);
  return true;
}

PyObject* install(PyObject*, PyObject*) {
  const char* cap_env = getenv("SB_POOL_CAP_BYTES");
  if (cap_env) {
    const long long v = atoll(cap_env);
    if (v > 0) g_cap = (size_t)v;
  }
  open_pool_file();  // best effort; anonymous fallback covers failure
  PyObject* capsule =
      PyCapsule_New(&g_handler, "mem_handler", (PyCapsule_Destructor) nullptr);
  if (!capsule) return nullptr;
  PyObject* old = PyDataMem_SetHandler(capsule);
  Py_DECREF(capsule);
  if (!old) return nullptr;
  Py_DECREF(old);
  return PyBool_FromLong(g_hdr != nullptr);
}

PyObject* stats(PyObject*, PyObject*) {
  std::lock_guard<std::mutex> lk(g_mu);
  uint64_t cursor = 0, nfree_shared = 0;
  if (g_hdr) {
    cursor = g_hdr->cursor;
    nfree_shared = g_hdr->nfree;
  }
  return Py_BuildValue(
      "{s:n,s:n,s:n,s:K,s:K,s:O}", "cached_bytes", (Py_ssize_t)g_cached,
      "live_blocks", (Py_ssize_t)g_live.size(), "free_blocks",
      (Py_ssize_t)g_free.size(), "file_cursor", (unsigned long long)cursor,
      "file_free_segs", (unsigned long long)nfree_shared, "file_backed",
      g_hdr ? Py_True : Py_False);
}

PyMethodDef methods[] = {
    {"install", install, METH_NOARGS,
     "Install the pooled tmpfs-backed allocator as numpy's data handler."},
    {"stats", stats, METH_NOARGS, "Pool statistics."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "sb_npalloc",
    "Pooled tmpfs-backed numpy allocator for lazy-memory hosts.",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_sb_npalloc(void) {
  import_array();  // initialize the numpy C API (PyDataMem_SetHandler)
  return PyModule_Create(&moduledef);
}
