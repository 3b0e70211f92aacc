// Sequential chunk prefetcher for disk-resident log-likelihood matrices.
//
// The reference workflow (reference pyloo/utils.py:21-79) ingests the whole
// (n_obs, n_draws) array through arviz, which caps it at host RAM.  The
// streaming estimators (pyloo_tpu_torch/streaming/) only ever need one
// chunk of rows at a time, so the loader's job is to keep the *next* chunk's
// disk read overlapped with the current chunk's device compute.  This file
// implements that as a single background producer thread pread()ing into a
// ring of page-aligned slots, with a copy-out consumer API:
//
//   void*   cr_open(path, data_offset, row_bytes, n_rows, chunk_rows, depth)
//   int64_t cr_read(handle, chunk_index, dst)   -> rows copied (0 past EOF,
//                                                  -1 error)
//   void    cr_close(handle)
//
// cr_read() copies the requested chunk into the caller's buffer and frees the
// ring slot immediately, so the caller owns its memory outright (no lifetime
// coupling with the ring).  Sequential consumption (the streaming loop's
// access pattern) always hits a prefetched slot; an out-of-order request
// (e.g. a checkpoint resume) resets the producer cursor and degrades to one
// synchronous read before prefetch resumes from the new position.
//
// Plain POSIX + std::thread; no external dependencies.  Python binds via
// ctypes (pyloo_tpu_torch/_native.py) with a numpy-memmap fallback when no
// compiler is available.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <stdlib.h>
#include <unistd.h>

namespace {

struct Slot {
  char* buf = nullptr;
  int64_t chunk = -1;   // which chunk this slot holds; -1 = empty
  int64_t rows = 0;     // rows actually read (tail chunk may be short)
  bool full = false;
};

struct Reader {
  int fd = -1;
  int64_t data_offset = 0;
  int64_t row_bytes = 0;
  int64_t n_rows = 0;
  int64_t chunk_rows = 0;
  int64_t n_chunks = 0;

  std::vector<Slot> slots;
  std::mutex m;
  std::condition_variable cv_produced;  // consumer waits for a full slot
  std::condition_variable cv_freed;     // producer waits for a free slot
  int64_t cursor = 0;                   // next chunk the producer will read
  int64_t in_flight = -1;               // chunk mid-pread (current generation)
  int64_t reads_issued = 0;             // chunk preads started (diagnostics)
  uint64_t generation = 0;              // bumped on every consumer seek/reset
  std::atomic<bool> stop{false};
  bool io_error = false;
  std::thread worker;
};

// Read chunk `chunk` fully into `dst`; returns rows read or -1 on I/O error.
int64_t read_chunk_sync(Reader* r, int64_t chunk, char* dst) {
  const int64_t start_row = chunk * r->chunk_rows;
  if (start_row >= r->n_rows) return 0;
  int64_t rows = r->n_rows - start_row;
  if (rows > r->chunk_rows) rows = r->chunk_rows;
  int64_t want = rows * r->row_bytes;
  int64_t off = r->data_offset + start_row * r->row_bytes;
  int64_t done = 0;
  while (done < want) {
    ssize_t got = pread(r->fd, dst + done, static_cast<size_t>(want - done),
                        static_cast<off_t>(off + done));
    if (got < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (got == 0) return -1;  // truncated file
    done += got;
  }
  return rows;
}

// Restart the prefetch pipeline at `chunk`: drop every buffered slot, void
// any pread in flight (generation bump), and point the producer's cursor at
// the requested chunk.  Caller holds r->m.
void reset_pipeline(Reader* r, int64_t chunk) {
  for (Slot& s : r->slots) {
    s.full = false;
    s.chunk = -1;
  }
  r->io_error = false;
  r->cursor = chunk;
  r->in_flight = -1;
  r->generation += 1;  // discard any pread currently in flight
  r->cv_freed.notify_all();
}

void producer_loop(Reader* r) {
  for (;;) {
    std::unique_lock<std::mutex> lk(r->m);
    int64_t chunk;
    Slot* slot;
    uint64_t gen;
    for (;;) {
      if (r->stop.load()) return;
      if (r->cursor >= r->n_chunks || r->io_error) {
        // Nothing left to prefetch; sleep until a seek resets the cursor.
        r->cv_freed.wait(lk);
        continue;
      }
      chunk = r->cursor;
      slot = &r->slots[static_cast<size_t>(chunk % (int64_t)r->slots.size())];
      if (!slot->full) break;  // slot free: claim it
      r->cv_freed.wait(lk);
    }
    r->cursor = chunk + 1;
    r->in_flight = chunk;
    r->reads_issued += 1;
    gen = r->generation;
    lk.unlock();

    int64_t rows = read_chunk_sync(r, chunk, slot->buf);

    lk.lock();
    if (r->stop.load()) return;
    if (gen != r->generation) continue;  // consumer seeked mid-read: discard
                                         // (the reset already cleared in_flight)
    r->in_flight = -1;
    if (rows < 0) {
      r->io_error = true;
      r->cv_produced.notify_all();
      continue;
    }
    slot->chunk = chunk;
    slot->rows = rows;
    slot->full = true;
    r->cv_produced.notify_all();
  }
}

}  // namespace

extern "C" {

void* cr_open(const char* path, int64_t data_offset, int64_t row_bytes,
              int64_t n_rows, int64_t chunk_rows, int64_t depth) {
  if (row_bytes <= 0 || n_rows < 0 || chunk_rows <= 0 || depth < 1 ||
      depth > 64) {
    return nullptr;
  }
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
#ifdef POSIX_FADV_SEQUENTIAL
  posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif

  Reader* r = new Reader();
  r->fd = fd;
  r->data_offset = data_offset;
  r->row_bytes = row_bytes;
  r->n_rows = n_rows;
  r->chunk_rows = chunk_rows;
  r->n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;

  const size_t slot_bytes =
      static_cast<size_t>(chunk_rows) * static_cast<size_t>(row_bytes);
  r->slots.resize(static_cast<size_t>(depth));
  for (Slot& s : r->slots) {
    void* p = nullptr;
    if (posix_memalign(&p, 4096, slot_bytes) != 0) {
      for (Slot& t : r->slots) free(t.buf);
      close(fd);
      delete r;
      return nullptr;
    }
    s.buf = static_cast<char*>(p);
  }
  r->worker = std::thread(producer_loop, r);
  return r;
}

int64_t cr_read(void* handle, int64_t chunk, char* dst) {
  Reader* r = static_cast<Reader*>(handle);
  if (r == nullptr || chunk < 0) return -1;
  if (chunk >= r->n_chunks) return 0;

  std::unique_lock<std::mutex> lk(r->m);
  Slot* slot =
      &r->slots[static_cast<size_t>(chunk % (int64_t)r->slots.size())];

  if (!(slot->full && slot->chunk == chunk)) {
    // Not buffered.  If the producer is not on track to deliver it (seek
    // backwards, or a stale slot from a previous pass occupies the ring),
    // reset the pipeline to start at `chunk`.  "On track" includes the
    // chunk being pread RIGHT NOW (in_flight): the cursor has already
    // advanced past it, and resetting there would discard and re-read every
    // chunk whenever the consumer outpaces the disk — the exact regime the
    // prefetcher exists for.
    //
    // "On track" must be PROVABLE delivery: waiting is only safe when the
    // producer reaches `chunk` without needing a slot freed, else both
    // sides block forever (producer on cv_freed for a stale full slot,
    // consumer on cv_produced).  In sequential consumption a missed chunk
    // is always either the one being pread right now (in_flight) or the
    // very next one the producer will claim (cursor) — both provably
    // deliverable.  Everything else is a skip or seek: reset the pipeline
    // to start at `chunk` (also the cheaper choice — a forward skip has no
    // use for the bypassed chunks, and a checkpoint resume at k < depth
    // should not read chunks 0..k-1 first).
    bool on_track =
        !r->io_error && (r->in_flight == chunk || r->cursor == chunk);
    if (!on_track || (slot->full && slot->chunk != chunk)) {
      reset_pipeline(r, chunk);
    }
    while (!(slot->full && slot->chunk == chunk) && !r->io_error) {
      r->cv_produced.wait(lk);
      // The on-track test above can be invalidated WHILE we wait when the
      // requested chunk and an earlier in-flight chunk alias the same ring
      // slot (depth=1: any skip; depth=d: skip landing on in_flight+d).
      // E.g. depth=1, in_flight=1, request chunk 2: cursor==2 says on-track,
      // but the producer lands chunk 1 into the only slot and then blocks on
      // cv_freed — while we'd wait here forever for chunk 2.  A full slot
      // holding the wrong chunk can only ever be freed by this consumer, so
      // the pipeline is provably wedged: reset it at `chunk` and keep
      // waiting.  The reset also voids the stale wake case where a previous
      // generation's pread completes after we were woken for io_error.
      if (slot->full && slot->chunk != chunk) {
        reset_pipeline(r, chunk);
      }
    }
    if (r->io_error) return -1;
  }

  int64_t rows = slot->rows;
  char* src = slot->buf;
  // Copy out under the lock: slots are MBs and memcpy is ~10 GB/s, while the
  // producer thread only contends for the lock between whole-chunk preads.
  std::memcpy(dst, src,
              static_cast<size_t>(rows) * static_cast<size_t>(r->row_bytes));
  slot->full = false;
  slot->chunk = -1;
  r->cv_freed.notify_all();
  return rows;
}

// Chunk preads started since open (diagnostics: a sequential full pass must
// issue exactly n_chunks reads — more means the pipeline reset and re-read).
int64_t cr_reads_issued(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r == nullptr) return -1;
  std::lock_guard<std::mutex> lk(r->m);
  return r->reads_issued;
}

void cr_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r == nullptr) return;
  {
    std::lock_guard<std::mutex> lk(r->m);
    r->stop.store(true);
    r->cv_freed.notify_all();
    r->cv_produced.notify_all();
  }
  if (r->worker.joinable()) r->worker.join();
  for (Slot& s : r->slots) free(s.buf);
  close(r->fd);
  delete r;
}

}  // extern "C"
