// Durable queue engine — the native runtime core of the messaging fabric.
//
// Role parity with the reference's embedded Apache Artemis broker
// (node/.../messaging/ArtemisMessagingServer.kt — a Java broker process
// doing durable store-and-forward with acks and redelivery). Re-designed
// as a small C++ engine with an append-only journal:
//
//   - named FIFO queues, competing consumers;
//   - publish is idempotent on msg_id (publisher dedupe — the processed-
//     message-table property of NodeMessagingClient.kt:187,429-439);
//   - consume leases a message for a visibility window; ack deletes,
//     expiry redelivers (at-least-once — VerifierTests.kt:75 elasticity);
//   - crash recovery by journal replay: pending = published − acked.
//
// Journal record format (little-endian):
//   [u8 kind][u32 body_len][body]
//   kind 1 = PUB: u16 qlen,q; u16 ilen,id; u16 slen,sender; u16 rlen,reply;
//                 u64 enqueued_us; u32 plen,payload
//   kind 2 = ACK: u16 ilen,id
//   kind 3 = DELIVERED (first lease): u16 ilen,id — so a crash-redelivered
//            message still reports redelivered=true after replay
//
// Exposed as a C ABI consumed by ctypes (corda_tpu_torch/messaging/native_queue.py;
// this file is the port's copy of the reference's native/queue_engine.cpp).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>  // std::runtime_error, which the headers above need not bring in
#include <string>
#include <unordered_map>
#include <deque>
#include <unordered_set>
#include <vector>

#ifndef _WIN32
#include <unistd.h>
#include <sys/types.h>
#endif

namespace {

using Clock = std::chrono::steady_clock;

double now_s() {
    return std::chrono::duration<double>(Clock::now().time_since_epoch())
        .count();
}

uint64_t wall_us() {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::system_clock::now().time_since_epoch())
        .count();
}

struct Pending {
    uint64_t seq;
    std::string queue, msg_id, sender, reply_to;
    std::string payload;
    uint64_t enqueued_us;
    double leased_until = 0.0;  // 0 = available
    int delivery_count = 0;
};

void put_u16(std::string& b, uint16_t v) { b.append((char*)&v, 2); }
void put_u32(std::string& b, uint32_t v) { b.append((char*)&v, 4); }
void put_u64(std::string& b, uint64_t v) { b.append((char*)&v, 8); }
void put_str16(std::string& b, const std::string& s) {
    put_u16(b, (uint16_t)s.size());
    b.append(s);
}

struct Reader {
    const char* p;
    const char* end;
    bool ok = true;
    template <typename T> T get() {
        if (p + sizeof(T) > end) { ok = false; return T{}; }
        T v;
        std::memcpy(&v, p, sizeof(T));
        p += sizeof(T);
        return v;
    }
    std::string str16() {
        uint16_t n = get<uint16_t>();
        if (!ok || p + n > end) { ok = false; return {}; }
        std::string s(p, n);
        p += n;
        return s;
    }
    std::string blob32() {
        uint32_t n = get<uint32_t>();
        if (!ok || p + n > end) { ok = false; return {}; }
        std::string s(p, n);
        p += n;
        return s;
    }
};

class Broker {
  public:
    Broker(const std::string& path, double visibility_s, bool fsync_each)
        : path_(path), visibility_s_(visibility_s), fsync_each_(fsync_each) {
        in_memory_ = path.empty() || path == ":memory:";
        if (!in_memory_) {
            // replay existing journal, then append. A crash can leave a
            // torn tail record; appending after it would make the NEXT
            // replay misparse everything that follows, so truncate to the
            // last well-formed record first.
            long good_end = 0;
            std::FILE* f = std::fopen(path.c_str(), "rb");
            if (f) {
                good_end = replay(f);
                std::fclose(f);
            }
#ifndef _WIN32
            if (good_end >= 0) {
                if (truncate(path.c_str(), good_end) != 0) {
                    // fall through: reopen append still works; worst case
                    // the torn tail persists and the next open retries
                }
            }
#endif
            log_ = std::fopen(path.c_str(), "ab");
            if (!log_) throw std::runtime_error("cannot open journal");
        }
    }

    ~Broker() {
        if (log_) std::fclose(log_);
    }

    bool publish(const std::string& queue, const std::string& msg_id,
                 const std::string& sender, const std::string& reply_to,
                 const std::string& payload) {
        std::unique_lock<std::mutex> lk(mu_);
        if (closed_ || failed_) return false;
        // dedupe: still-pending or recently-acked ids are silent no-ops
        if (by_id_.count(msg_id) || acked_set_.count(msg_id)) return true;
        auto msg = std::make_shared<Pending>();
        msg->seq = next_seq_++;
        msg->queue = queue;
        msg->msg_id = msg_id;
        msg->sender = sender;
        msg->reply_to = reply_to;
        msg->payload = payload;
        msg->enqueued_us = wall_us();
        by_id_[msg_id] = msg;
        queues_[queue][msg->seq] = msg;
        if (log_) {
            std::string body;
            put_str16(body, queue);
            put_str16(body, msg_id);
            put_str16(body, sender);
            put_str16(body, reply_to);
            put_u64(body, msg->enqueued_us);
            put_u32(body, (uint32_t)payload.size());
            body.append(payload);
            write_record(1, body);
        }
        cv_.notify_all();
        return true;
    }

    // Returns a malloc'd packed message or nullptr on timeout/closed.
    // Layout: u32 idlen,id; u32 slen,sender; u32 rlen,reply; u8 redelivered;
    //         u64 enqueued_us; u32 plen,payload
    char* consume(const std::string& queue, double timeout_s,
                  uint32_t* out_len) {
        std::unique_lock<std::mutex> lk(mu_);
        double deadline = timeout_s < 0 ? -1 : now_s() + timeout_s;
        while (true) {
            if (closed_) return nullptr;
            Pending* m = try_lease(queue);
            if (m) return pack(m, out_len);
            double now = now_s();
            if (deadline >= 0 && now >= deadline) return nullptr;
            double wait = 0.2;  // bounded: re-offer expired leases
            if (deadline >= 0 && deadline - now < wait) wait = deadline - now;
            cv_.wait_for(lk, std::chrono::duration<double>(wait));
        }
    }

    bool ack(const std::string& msg_id) {
        std::unique_lock<std::mutex> lk(mu_);
        if (failed_) return false;
        auto it = by_id_.find(msg_id);
        if (it == by_id_.end()) return false;
        auto msg = it->second;
        queues_[msg->queue].erase(msg->seq);
        by_id_.erase(it);
        acked_count_++;
        remember_acked(msg_id);
        if (log_) {
            std::string body;
            put_str16(body, msg_id);
            write_record(2, body);
        }
        cv_.notify_all();
        return true;
    }

    bool nack(const std::string& msg_id) {
        std::unique_lock<std::mutex> lk(mu_);
        auto it = by_id_.find(msg_id);
        if (it == by_id_.end()) return false;
        it->second->leased_until = 0.0;  // immediately re-deliverable
        cv_.notify_all();
        return true;
    }

    int64_t depth(const std::string& queue) {
        std::unique_lock<std::mutex> lk(mu_);
        auto it = queues_.find(queue);
        return it == queues_.end() ? 0 : (int64_t)it->second.size();
    }

    // newline-joined names of non-empty queues (malloc'd; caller frees)
    char* queue_list(uint32_t* out_len) {
        std::unique_lock<std::mutex> lk(mu_);
        std::string b;
        for (auto& [name, q] : queues_) {
            if (q.empty()) continue;
            if (!b.empty()) b.push_back('\n');
            b.append(name);
        }
        char* out = (char*)std::malloc(b.size() ? b.size() : 1);
        std::memcpy(out, b.data(), b.size());
        *out_len = (uint32_t)b.size();
        return out;
    }

    void close() {
        std::unique_lock<std::mutex> lk(mu_);
        closed_ = true;
        if (log_) {
            std::fflush(log_);
#ifndef _WIN32
            fsync(fileno(log_));
#endif
        }
        cv_.notify_all();
    }

  private:
    Pending* try_lease(const std::string& queue) {
        auto qit = queues_.find(queue);
        if (qit == queues_.end()) return nullptr;
        double now = now_s();
        for (auto& [seq, msg] : qit->second) {
            if (msg->leased_until <= now) {
                msg->leased_until = now + visibility_s_;
                msg->delivery_count++;
                if (msg->delivery_count == 1 && log_) {
                    // persist first delivery: after a crash the replayed
                    // message must redeliver flagged redelivered=true
                    std::string body;
                    put_str16(body, msg->msg_id);
                    write_record(3, body);
                }
                return msg.get();
            }
        }
        return nullptr;
    }

    static char* pack(const Pending* m, uint32_t* out_len) {
        std::string b;
        put_u32(b, (uint32_t)m->msg_id.size());
        b.append(m->msg_id);
        put_u32(b, (uint32_t)m->sender.size());
        b.append(m->sender);
        put_u32(b, (uint32_t)m->reply_to.size());
        b.append(m->reply_to);
        b.push_back(m->delivery_count > 1 ? 1 : 0);
        put_u64(b, m->enqueued_us);
        put_u32(b, (uint32_t)m->payload.size());
        b.append(m->payload);
        char* out = (char*)std::malloc(b.size());
        std::memcpy(out, b.data(), b.size());
        *out_len = (uint32_t)b.size();
        return out;
    }

    // Artemis-style bounded duplicate-ID cache: acked ids are remembered
    // FIFO up to a cap (pending ids dedupe via by_id_ regardless)
    static constexpr size_t kAckedCacheMax = 100000;
    void remember_acked(const std::string& id) {
        if (acked_set_.insert(id).second) {
            acked_fifo_.push_back(id);
            while (acked_fifo_.size() > kAckedCacheMax) {
                acked_set_.erase(acked_fifo_.front());
                acked_fifo_.pop_front();
            }
        }
    }

    void write_record(uint8_t kind, const std::string& body) {
        // a short write (disk full, I/O error) must NOT be reported as
        // durable success: flag the broker failed so publish/ack refuse
        // further work instead of silently diverging from the journal
        uint32_t len = (uint32_t)body.size();
        bool ok = std::fwrite(&kind, 1, 1, log_) == 1
            && std::fwrite(&len, 4, 1, log_) == 1
            && std::fwrite(body.data(), 1, body.size(), log_) == body.size()
            && std::fflush(log_) == 0;
        if (ok && fsync_each_) {
#ifndef _WIN32
            ok = fsync(fileno(log_)) == 0;
#endif
        }
        if (!ok) failed_ = true;
    }

    long replay(std::FILE* f) {
        std::vector<char> buf;
        long good_end = 0;
        while (true) {
            uint8_t kind;
            uint32_t len;
            if (std::fread(&kind, 1, 1, f) != 1) break;
            if (std::fread(&len, 4, 1, f) != 1) break;
            if (len > (64u << 20)) break;  // garbage length: stop at tear
            buf.resize(len);
            if (len && std::fread(buf.data(), 1, len, f) != len)
                break;  // torn tail record: truncated by the caller
            Reader r{buf.data(), buf.data() + len};
            if (kind == 1) {
                auto msg = std::make_shared<Pending>();
                msg->queue = r.str16();
                msg->msg_id = r.str16();
                msg->sender = r.str16();
                msg->reply_to = r.str16();
                msg->enqueued_us = r.get<uint64_t>();
                msg->payload = r.blob32();
                if (!r.ok) break;
                msg->seq = next_seq_++;
                by_id_[msg->msg_id] = msg;
                queues_[msg->queue][msg->seq] = msg;
            } else if (kind == 2) {
                std::string id = r.str16();
                if (!r.ok) break;
                auto it = by_id_.find(id);
                if (it != by_id_.end()) {
                    queues_[it->second->queue].erase(it->second->seq);
                    by_id_.erase(it);
                }
                remember_acked(id);
            } else if (kind == 3) {
                std::string id = r.str16();
                if (!r.ok) break;
                auto it = by_id_.find(id);
                if (it != by_id_.end()) it->second->delivery_count = 1;
            } else {
                break;  // unknown kind: stop at corruption
            }
            good_end = std::ftell(f);
        }
        return good_end;
    }

    std::string path_;
    double visibility_s_;
    bool fsync_each_;
    bool in_memory_ = false;
    bool closed_ = false;
    bool failed_ = false;
    std::FILE* log_ = nullptr;
    std::mutex mu_;
    std::condition_variable cv_;
    uint64_t next_seq_ = 1;
    uint64_t acked_count_ = 0;
    std::deque<std::string> acked_fifo_;
    std::unordered_set<std::string> acked_set_;
    std::unordered_map<std::string, std::shared_ptr<Pending>> by_id_;
    std::map<std::string, std::map<uint64_t, std::shared_ptr<Pending>>>
        queues_;
};

std::mutex g_reg_mu;
std::unordered_map<int64_t, std::shared_ptr<Broker>> g_brokers;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

int64_t ctq_open(const char* path, double visibility_s, int fsync_each) {
    try {
        auto broker = std::make_shared<Broker>(
            path ? path : "", visibility_s, fsync_each != 0);
        std::lock_guard<std::mutex> lk(g_reg_mu);
        int64_t h = g_next_handle++;
        g_brokers[h] = std::move(broker);
        return h;
    } catch (...) {
        return 0;
    }
}

// returns an owning reference: a concurrent ctq_close cannot free the
// broker out from under a blocked consume
static std::shared_ptr<Broker> get(int64_t h) {
    std::lock_guard<std::mutex> lk(g_reg_mu);
    auto it = g_brokers.find(h);
    return it == g_brokers.end() ? nullptr : it->second;
}

int ctq_publish(int64_t h, const char* queue, const char* msg_id,
                const char* sender, const char* reply_to,
                const char* payload, uint32_t payload_len) {
    auto b = get(h);
    if (!b) return 0;
    return b->publish(queue, msg_id, sender ? sender : "",
                      reply_to ? reply_to : "",
                      std::string(payload, payload_len))
               ? 1
               : 0;
}

char* ctq_consume(int64_t h, const char* queue, double timeout_s,
                  uint32_t* out_len) {
    auto b = get(h);
    if (!b) return nullptr;
    return b->consume(queue, timeout_s, out_len);
}

int ctq_ack(int64_t h, const char* msg_id) {
    auto b = get(h);
    return b && b->ack(msg_id) ? 1 : 0;
}

int ctq_nack(int64_t h, const char* msg_id) {
    auto b = get(h);
    return b && b->nack(msg_id) ? 1 : 0;
}

int64_t ctq_depth(int64_t h, const char* queue) {
    auto b = get(h);
    return b ? b->depth(queue) : -1;
}

char* ctq_queues(int64_t h, uint32_t* out_len) {
    auto b = get(h);
    if (!b) return nullptr;
    return b->queue_list(out_len);
}

void ctq_free(char* p) { std::free(p); }

void ctq_close(int64_t h) {
    auto b = get(h);
    if (b) b->close();
    std::lock_guard<std::mutex> lk(g_reg_mu);
    g_brokers.erase(h);
}

}  // extern "C"
