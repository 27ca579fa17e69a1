// mpmcio: native runtime for mpmcxx_tpu_torch.
//
// The port's own copy of the JAX package's codec (mpmcxx_tpu/runtime/
// mpmcio.cpp); the two write the same bytes.  The reference engine's
// runtime-around-the-physics is C++ (file writers in
// src/System.Output.cpp, the PQR parser in src/System.cpp:507-854, the
// corrtime bookkeeping in src/System.MonteCarlo.cpp:1902-2028).  This
// library is the PyTorch port's native counterpart:
//
//  * pqr_format(): bulk PQR frame serialisation from flat arrays (the
//    restart/trajectory hot path every corrtime) — one pass, no Python
//    string machinery.
//  * pqr_parse(): bulk ATOM-record parsing into flat arrays.
//  * an async writer: a background thread with a bounded job queue so
//    restart/trajectory writes never stall the thread that feeds the GPU
//    between chunks (the reference serialises ranks through MPI_Barrier
//    and blocks on fwrite; here the card keeps stepping while the host
//    flushes).
//
// Exposed with a plain C ABI for ctypes (runtime/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdarg>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PQR formatting
// ---------------------------------------------------------------------------

// Serialise n atoms into `out` (caller-allocated, cap bytes).  Returns bytes
// written, or -1 if cap is too small.  Layout of the numeric columns matches
// write_molecules (reference src/System.Output.cpp:947-1001).
long long pqr_format(
    int n,
    const char* atomtype,       // n * 8 bytes, NUL padded
    const char* moleculetype,   // n * 8 bytes
    const char* flag,           // n bytes ('M','F','A','S','T')
    const int* molecule_id,     // n
    const double* pos,          // n*3
    const double* params,       // n*11: mass, charge_e, alpha, eps, sigma,
                                //       omega, gwp_alpha, c6, c8, c10, c9
    int ext_output,             // 1 -> %11.6f coords
    char* out, long long cap) {
  long long w = 0;
  for (int i = 0; i < n; i++) {
    if (cap - w < 512) return -1;
    char at[9] = {0}, mt[9] = {0};
    memcpy(at, atomtype + 8 * i, 8);
    memcpy(mt, moleculetype + 8 * i, 8);
    w += snprintf(out + w, cap - w, "ATOM  %5d %-4.4s %-3.3s %-1.1s %4d   ",
                  i + 1, at, mt, flag + i, molecule_id[i]);
    const double* p = pos + 3 * i;
    if (ext_output)
      w += snprintf(out + w, cap - w, "%11.6f %11.6f %11.6f ",
                    p[0], p[1], p[2]);
    else
      w += snprintf(out + w, cap - w, "%8.3f%8.3f%8.3f", p[0], p[1], p[2]);
    const double* q = params + 11 * i;
    for (int j = 0; j < 11; j++)
      w += snprintf(out + w, cap - w, " %8.5f", q[j]);
    out[w++] = '\n';
  }
  return w;
}

// Parse ATOM records from `text`.  Fills flat arrays sized max_atoms.
// Returns the number of atoms parsed (BOX pseudo-atoms skipped), or
// -(lineno) on a malformed line.
long long pqr_parse(
    const char* text, long long len, int max_atoms,
    char* atomtype,        // max*8
    char* moleculetype,    // max*8
    char* flag,            // max
    int* molecule_id,
    double* pos,           // max*3
    double* params) {      // max*11
  int count = 0;
  long long i = 0;
  long long lineno = 0;
  while (i < len && count < max_atoms) {
    lineno++;
    long long j = i;
    while (j < len && text[j] != '\n') j++;
    std::string line(text + i, j - i);
    i = j + 1;
    if (line.compare(0, 4, "ATOM") != 0) {
      if (line.compare(0, 3, "END") == 0) break;
      continue;
    }
    char at[64] = {0}, mt[64] = {0}, fl[64] = {0};
    int id = 0, mid = 0;
    double vals[14] = {0};
    int got = sscanf(line.c_str(),
                     "%*s %d %63s %63s %63s %d %lf %lf %lf %lf %lf %lf %lf "
                     "%lf %lf %lf %lf %lf %lf %lf",
                     &id, at, mt, fl, &mid,
                     &vals[0], &vals[1], &vals[2], &vals[3], &vals[4],
                     &vals[5], &vals[6], &vals[7], &vals[8], &vals[9],
                     &vals[10], &vals[11], &vals[12], &vals[13]);
    if (got < 8) return -lineno;
    if (strcmp(mt, "BOX") == 0) continue;
    memset(atomtype + 8 * count, 0, 8);
    strncpy(atomtype + 8 * count, at, 7);
    memset(moleculetype + 8 * count, 0, 8);
    strncpy(moleculetype + 8 * count, mt, 7);
    flag[count] = fl[0] ? fl[0] : 'M';
    molecule_id[count] = mid;
    pos[3 * count + 0] = vals[0];
    pos[3 * count + 1] = vals[1];
    pos[3 * count + 2] = vals[2];
    // mass charge alpha eps sigma omega gwp c6 c8 c10 c9
    for (int k = 0; k < 11; k++) params[11 * count + k] = vals[3 + k];
    count++;
  }
  return count;
}

// ---------------------------------------------------------------------------
// async writer
// ---------------------------------------------------------------------------

namespace {

struct Job {
  std::string path;
  std::string data;
  bool rotate_last;  // rename existing file to path+".last" first
};

class AsyncWriter {
 public:
  AsyncWriter() : stop_(false), errors_(0) {
    worker_ = std::thread([this] { run(); });
  }
  ~AsyncWriter() { shutdown(); }

  void enqueue(Job&& job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      // bounded queue: don't let a slow disk buffer unbounded frames
      cv_space_.wait(lk, [this] { return queue_.size() < 64 || stop_; });
      if (stop_) return;
      queue_.emplace_back(std::move(job));
    }
    cv_work_.notify_one();
  }

  void drain() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_space_.wait(lk, [this] { return queue_.empty() && !busy_; });
  }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_space_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  long long errors() const { return errors_.load(); }

 private:
  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [this] { return !queue_.empty() || stop_; });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
        busy_ = true;
      }
      write_one(job);
      {
        std::lock_guard<std::mutex> lk(mu_);
        busy_ = false;
      }
      cv_space_.notify_all();
    }
  }

  void write_one(const Job& job) {
    if (job.path == "/dev/null") return;
    if (job.rotate_last) {
      std::string last = job.path + ".last";
      (void)rename(job.path.c_str(), last.c_str());
    }
    FILE* f = fopen(job.path.c_str(), job.rotate_last ? "w" : "a");
    if (!f) {
      errors_++;
      return;
    }
    if (fwrite(job.data.data(), 1, job.data.size(), f) != job.data.size())
      errors_++;
    fclose(f);
  }

  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_space_;
  std::deque<Job> queue_;
  bool stop_;
  bool busy_ = false;
  std::atomic<long long> errors_;
};

AsyncWriter* g_writer = nullptr;
std::mutex g_writer_mu;

AsyncWriter* writer() {
  std::lock_guard<std::mutex> lk(g_writer_mu);
  if (!g_writer) g_writer = new AsyncWriter();
  return g_writer;
}

}  // namespace

// Queue a write. rotate_last=1 reproduces the reference's `.last` restart
// rotation (src/System.Output.cpp:880-886) before an overwrite; 0 appends.
void async_write(const char* path, const char* data, long long len,
                 int rotate_last) {
  Job j;
  j.path = path;
  j.data.assign(data, (size_t)len);
  j.rotate_last = rotate_last != 0;
  writer()->enqueue(std::move(j));
}

// Block until all queued writes are on disk.
void async_drain() { writer()->drain(); }

// Number of failed writes since start.
long long async_errors() { return writer()->errors(); }

void async_shutdown() {
  std::lock_guard<std::mutex> lk(g_writer_mu);
  if (g_writer) {
    g_writer->shutdown();
    delete g_writer;
    g_writer = nullptr;
  }
}

}  // extern "C"
