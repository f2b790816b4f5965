// SPSC frame ring buffer — the native runtime piece of the streaming
// pipeline (animal_vision_tpu_torch/pipeline/executor.py). A copy of the JAX
// package's animal_vision_tpu/native/framering.cpp with the same C ABI, plus
// ring_read_into, which copies a slot straight into a caller's buffer (a
// pinned tensor) in one memcpy.
//
// The reference's only "queue" is a Python deque guarded by the GIL
// (server/server.py:26-43). Decoding 1080p frames at >100 fps through
// Python queues costs GIL handoffs per frame; this ring passes frames
// between the decode thread and the dispatch thread through preallocated
// slots with lock-free acquire/release (C++11 atomics, single producer /
// single consumer). Python sees the slots as zero-copy numpy views
// (ctypes; see ring.py).
//
// Build: native/ring.py runs g++ -O3 -shared -fPIC -std=c++17 at first use
// into build/native/framering-<hash>.so.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

struct Ring {
    uint8_t* data;          // n_slots * slot_bytes
    uint64_t* sizes;        // committed byte counts per slot
    int64_t slot_bytes;
    int64_t n_slots;
    std::atomic<int64_t> head;  // next slot to write (producer-owned)
    std::atomic<int64_t> tail;  // next slot to read (consumer-owned)
    std::atomic<int32_t> closed;
};

}  // namespace

extern "C" {

void* ring_create(int64_t slot_bytes, int64_t n_slots) {
    if (slot_bytes <= 0 || n_slots <= 1) return nullptr;
    Ring* r = new (std::nothrow) Ring();
    if (!r) return nullptr;
    r->data = static_cast<uint8_t*>(std::malloc(size_t(slot_bytes) * size_t(n_slots)));
    r->sizes = static_cast<uint64_t*>(std::calloc(size_t(n_slots), sizeof(uint64_t)));
    if (!r->data || !r->sizes) {
        std::free(r->data);
        std::free(r->sizes);
        delete r;
        return nullptr;
    }
    r->slot_bytes = slot_bytes;
    r->n_slots = n_slots;
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    r->closed.store(0, std::memory_order_relaxed);
    return r;
}

void ring_destroy(void* h) {
    Ring* r = static_cast<Ring*>(h);
    if (!r) return;
    std::free(r->data);
    std::free(r->sizes);
    delete r;
}

// Producer: pointer to the next writable slot, or nullptr when full.
uint8_t* ring_acquire_write(void* h) {
    Ring* r = static_cast<Ring*>(h);
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    if (head - tail >= r->n_slots - 1) return nullptr;  // full (one slot gap)
    return r->data + (head % r->n_slots) * r->slot_bytes;
}

// Producer: publish the slot previously acquired.
void ring_commit_write(void* h, int64_t nbytes) {
    Ring* r = static_cast<Ring*>(h);
    int64_t head = r->head.load(std::memory_order_relaxed);
    r->sizes[head % r->n_slots] = uint64_t(nbytes);
    r->head.store(head + 1, std::memory_order_release);
}

// Consumer: pointer to the next readable slot (size in *nbytes), nullptr
// when empty.
uint8_t* ring_acquire_read(void* h, int64_t* nbytes) {
    Ring* r = static_cast<Ring*>(h);
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    if (tail >= head) return nullptr;  // empty
    *nbytes = int64_t(r->sizes[tail % r->n_slots]);
    return r->data + (tail % r->n_slots) * r->slot_bytes;
}

// Consumer: free the slot previously acquired for reading.
void ring_release_read(void* h) {
    Ring* r = static_cast<Ring*>(h);
    r->tail.store(r->tail.load(std::memory_order_relaxed) + 1,
                  std::memory_order_release);
}

// Consumer: copy the next readable slot into dst (capacity dst_bytes) and
// free the slot. Returns the slot's byte count, -1 when the ring is empty, or
// -2 when the slot does not fit dst (the slot stays readable).
int64_t ring_read_into(void* h, uint8_t* dst, int64_t dst_bytes) {
    int64_t nbytes = 0;
    uint8_t* src = ring_acquire_read(h, &nbytes);
    if (!src) return -1;
    if (nbytes > dst_bytes) return -2;
    std::memcpy(dst, src, size_t(nbytes));
    ring_release_read(h);
    return nbytes;
}

void ring_close(void* h) {
    static_cast<Ring*>(h)->closed.store(1, std::memory_order_release);
}

int32_t ring_is_closed(void* h) {
    return static_cast<Ring*>(h)->closed.load(std::memory_order_acquire);
}

int64_t ring_size(void* h) {
    Ring* r = static_cast<Ring*>(h);
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
