// ledgerstore — native storage engine for the trial ledger.
//
// The PyTorch port's own copy of metaopt_tpu/native/ledgerstore.cpp: the
// same engine and the same on-disk format byte for byte, so either package
// reads and writes the other's stores. It backs the file-backed ledger with
// an append-only record log per experiment and an in-memory index, where
// every mutation is serialized by an exclusive flock and readers replay the
// log tail before acting — multi-process linearizable CAS without a
// database server. The Python FileLedger rewrites a JSON file per trial
// mutation; this engine appends one small record instead (heartbeats are
// ~40 bytes, not a full document rewrite).
//
// Layering: the engine is deliberately payload-agnostic. It owns the
// concurrency-critical fields (key, status, worker, heartbeat) and treats
// the trial document as opaque bytes supplied by Python. Keys/statuses/
// workers must not contain '"' or '\\' (they are hex ids and enum strings;
// the Python wrapper enforces this) so envelopes can be emitted without a
// JSON library.
//
// Log format, little-endian:
//   magic "MTPULDG1" (8 bytes), then records:
//   u32 body_len | u8 op | u16 key_len,key | u16 status_len,status |
//   u16 worker_len,worker | f64 heartbeat | u32 payload_len,payload
//   op: 1=put (insert-only)  2=set (status/worker/hb + payload)
//       3=mark (status/worker/hb, payload unchanged)  4=beat (hb only)
// A torn tail record (crash mid-write) is detected by body_len overrunning
// EOF and ignored; the next writer truncates it.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 ledgerstore.cpp -o libledgerstore.so
// (metaopt_tpu_torch/utils/cuda_build.py::build_host, into _build/)

#include <sys/file.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <fcntl.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <string>
#include <unordered_map>
#include <algorithm>
#include <set>
#include <utility>
#include <vector>

namespace {

constexpr char kMagic[8] = {'M', 'T', 'P', 'U', 'L', 'D', 'G', '1'};
// v2 header: magic + an 8-byte random epoch. The epoch identifies THIS
// log file's history for fetch_since cursors — an inode number cannot
// (inodes are recycled: a later compaction's tmp file can be allocated a
// previously-freed inode, making a stale cursor read as current).
constexpr char kMagic2[8] = {'M', 'T', 'P', 'U', 'L', 'D', 'G', '2'};

uint64_t random_epoch() {
  uint64_t e = 0;
  int fd = ::open("/dev/urandom", O_RDONLY);
  if (fd >= 0) {
    if (::read(fd, &e, sizeof(e)) != sizeof(e)) e = 0;
    ::close(fd);
  }
  if (e == 0) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    e = (static_cast<uint64_t>(ts.tv_sec) << 30) ^
        static_cast<uint64_t>(ts.tv_nsec) ^
        (static_cast<uint64_t>(getpid()) << 48);
  }
  return e ? e : 1;
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<double>(ts.tv_sec) + ts.tv_nsec * 1e-9;
}

struct Entry {
  std::string status;
  std::string worker;
  double heartbeat = 0.0;
  double order = 0.0;  // client-supplied sort key (submit time): FIFO reserve
  std::string payload;
  uint64_t last_seq = 0;  // seq of the last applied record touching this key
};

struct Record {
  uint8_t op;
  std::string key, status, worker, payload;
  double heartbeat;
};

class Store {
 public:
  explicit Store(const std::string& dir) : dir_(dir) {
    ::mkdir(dir.c_str(), 0777);
    lock_fd_ = ::open((dir + "/lock").c_str(), O_CREAT | O_RDWR, 0666);
    log_fd_ = ::open((dir + "/trials.log").c_str(),
                     O_CREAT | O_RDWR | O_APPEND, 0666);
    if (lock_fd_ >= 0 && log_fd_ >= 0) {
      // header init under the lock: two processes first-opening the store
      // must not both append it (it would desync byte accounting)
      ::flock(lock_fd_, LOCK_EX);
      read_or_init_header();
      ::flock(lock_fd_, LOCK_UN);
    }
  }

  // Reads the log header, initializing an empty file with the v2 header
  // (magic + random epoch). v1 logs (magic only) fall back to the inode
  // as epoch — imperfect (recyclable) but preserves old stores. Caller
  // holds the lock. Sets epoch_ and applied_.
  void read_or_init_header() {
    struct stat st;
    if (fstat(log_fd_, &st) != 0) return;
    if (st.st_size == 0) {
      epoch_ = random_epoch();
      std::string hdr(kMagic2, sizeof(kMagic2));
      hdr.append(reinterpret_cast<const char*>(&epoch_), sizeof(epoch_));
      ::write(log_fd_, hdr.data(), hdr.size());
      applied_ = hdr.size();
      return;
    }
    char magic[8] = {0};
    if (::pread(log_fd_, magic, sizeof(magic), 0) == sizeof(magic) &&
        memcmp(magic, kMagic2, sizeof(kMagic2)) == 0 &&
        ::pread(log_fd_, &epoch_, sizeof(epoch_), sizeof(magic)) ==
            sizeof(epoch_)) {
      applied_ = sizeof(kMagic2) + sizeof(epoch_);
      return;
    }
    if (memcmp(magic, kMagic, sizeof(kMagic)) == 0) {  // legacy v1 log
      epoch_ = static_cast<uint64_t>(st.st_ino);
      applied_ = sizeof(kMagic);
      return;
    }
    // UNKNOWN format (a future version, or not our file): never parse,
    // never truncate, and never APPEND — mixing v2 records into a log
    // this build does not understand corrupts it for the build that
    // does. The store becomes read-only-empty: reads see nothing,
    // writes fail loudly.
    foreign_ = true;
    epoch_ = static_cast<uint64_t>(st.st_ino);
    applied_ = static_cast<size_t>(st.st_size);
  }

  ~Store() {
    if (lock_fd_ >= 0) ::close(lock_fd_);
    if (log_fd_ >= 0) ::close(log_fd_);
  }

  bool ok() const { return lock_fd_ >= 0 && log_fd_ >= 0; }

  // ---- locked section helpers ----
  class Guard {
   public:
    explicit Guard(Store* s) : s_(s) {
      ::flock(s_->lock_fd_, LOCK_EX);
      s_->maybe_reopen();
      s_->replay_tail();
    }
    ~Guard() { ::flock(s_->lock_fd_, LOCK_UN); }

   private:
    Store* s_;
  };

  // ---- ops (each takes the lock itself) ----
  // sort_key (the trial's submit time) fixes FIFO reserve order across
  // processes that register out of order. Travels in the record's hb slot.
  int put(const char* key, const char* status, const char* payload,
          double sort_key) {
    Guard g(this);
    if (index_.count(key)) return 1;  // duplicate
    Record r{1, key, status, "", payload, sort_key};
    if (!append(r)) return -1;
    apply(r);
    return 0;
  }

  // CAS update: expected_* of "" means "don't check".
  // new_worker/new_payload of "" mean "keep". hb is caller-supplied (the
  // updated document is authoritative, e.g. a backdated heartbeat in
  // tests). Returns 0 ok, 1 cas-fail, 2 missing key.
  int cas(const char* key, const char* exp_status, const char* exp_worker,
          const char* new_status, const char* new_worker,
          const char* new_payload, double hb) {
    Guard g(this);
    auto it = index_.find(key);
    if (it == index_.end()) return 2;
    if (exp_status[0] && it->second.status != exp_status) return 1;
    if (exp_worker[0] && it->second.worker != exp_worker) return 1;
    Record r{static_cast<uint8_t>(new_payload[0] ? 2 : 3),
             key,
             new_status[0] ? new_status : it->second.status,
             new_worker[0] ? new_worker : it->second.worker,
             new_payload,
             hb};
    if (!append(r)) return -1;
    apply(r);
    return 0;
  }

  // Reserve the oldest 'new' entry (min (sort_key, key)): status →
  // reserved, stamp worker + hb. Returns envelope or "". O(log n): the
  // FIFO candidate is the head of new_set_.
  std::string reserve(const char* worker) {
    Guard g(this);
    if (new_set_.empty()) return "";
    const std::string best = new_set_.begin()->second;
    Record r{3, best, "reserved", worker, "", now_s()};
    if (!append(r)) return "";
    apply(r);
    return envelope(best, index_.at(best));
  }

  int beat(const char* key, const char* worker) {
    Guard g(this);
    auto it = index_.find(key);
    if (it == index_.end() || it->second.status != "reserved" ||
        it->second.worker != worker)
      return 1;
    Record r{4, key, "", "", "", now_s()};
    if (!append(r)) return -1;
    apply(r);
    return 0;
  }

  std::string release_stale(double timeout_s) {
    Guard g(this);
    const double cutoff = now_s() - timeout_s;
    std::string out;
    // reserved_set_ orders by heartbeat: stale claims are a prefix, so
    // each release pops the head (apply() moves it to new_set_)
    while (!reserved_set_.empty() && reserved_set_.begin()->first < cutoff) {
      const std::string key = reserved_set_.begin()->second;
      Record r{3, key, "new", "", "", 0.0};
      if (!append(r)) break;
      apply(r);
      out += envelope(key, index_.at(key));  // post-release: back to 'new'
      out += '\n';
    }
    return out;
  }

  // Wipe: drop every entry (experiment deletion). Deletion is an APPENDED
  // record, never an unlink — the lock file and log inode survive, so
  // handles held by other processes replay the wipe on their next locked
  // op instead of forking the lock identity (the hazard that made delete
  // unsupported before). Seqs keep climbing and the epoch is unchanged:
  // a fetch_since cursor from the pre-wipe life stays valid and simply
  // sees nothing until post-wipe records land.
  int wipe() {
    Guard g(this);
    Record r{5, "", "", "", "", 0.0};
    if (!append(r)) return -1;
    apply(r);
    return 0;
  }

  std::string get(const char* key) {
    Guard g(this);
    auto it = index_.find(key);
    if (it == index_.end()) return "";
    return envelope(it->first, it->second);
  }

  std::string fetch(const char* status_csv) {
    Guard g(this);
    std::vector<std::string> wanted = split_csv(status_csv);
    std::string out;
    for (const auto& key : order_) {
      auto it = index_.find(key);
      if (it == index_.end()) continue;
      if (!wanted.empty() && !contains(wanted, it->second.status)) continue;
      out += envelope(key, it->second);
      out += '\n';
    }
    return out;
  }

  // Incremental fetch: entries matching status whose last touching record
  // was applied after `seq` of epoch `epoch`. Every process replaying the
  // same log assigns identical seqs (a deterministic count of applied
  // records), so a cursor handed out by one handle is valid in any other
  // — until compaction replaces the log (new inode = new epoch), which
  // invalidates cursors and forces one full refetch. First line of the
  // result: "C <epoch> <max_seq>"; envelopes follow.
  std::string fetch_since(const char* status_csv, uint64_t epoch,
                          uint64_t seq) {
    Guard g(this);
    uint64_t cur_epoch = epoch_;
    if (epoch != cur_epoch) seq = 0;  // stale cursor: full scan once
    std::vector<std::string> wanted = split_csv(status_csv);
    char head[64];
    snprintf(head, sizeof(head), "C %llu %llu\n",
             static_cast<unsigned long long>(cur_epoch),
             static_cast<unsigned long long>(seq_));
    std::string out = head;
    if (wanted.size() == 1 && wanted[0] == "completed") {
      // the hot path (incremental observe): completion events are an
      // append-only, seq-sorted vector — binary search to the cursor
      // instead of scanning every entry. Events may repeat a key
      // (re-marks); dedup here, and re-check the entry's CURRENT status
      // so a completed→new reset never resurfaces.
      auto lb = std::lower_bound(
          completed_events_.begin(), completed_events_.end(),
          std::make_pair(seq + 1, std::string()));
      std::set<std::string> seen;
      for (auto ev = lb; ev != completed_events_.end(); ++ev) {
        if (!seen.insert(ev->second).second) continue;
        auto it = index_.find(ev->second);
        if (it == index_.end() || it->second.status != "completed") continue;
        if (it->second.last_seq <= seq) continue;
        out += envelope(ev->second, it->second);
        out += '\n';
      }
      return out;
    }
    for (const auto& key : order_) {
      auto it = index_.find(key);
      if (it == index_.end()) continue;
      if (it->second.last_seq <= seq) continue;
      if (!wanted.empty() && !contains(wanted, it->second.status)) continue;
      out += envelope(key, it->second);
      out += '\n';
    }
    return out;
  }

  long count(const char* status_csv) {
    Guard g(this);
    std::vector<std::string> wanted = split_csv(status_csv);
    long n = 0;
    if (wanted.empty()) {
      for (const auto& kv : status_counts_) n += kv.second;
      return n;
    }
    for (const auto& w : wanted) {
      auto it = status_counts_.find(w);
      if (it != status_counts_.end()) n += it->second;
    }
    return n;
  }

  // Rewrite the log as two records per live key (a put carrying the FIFO
  // sort key, then a mark restoring worker/heartbeat) — heartbeat spam and
  // superseded document versions vanish. Other live processes detect the
  // inode change under the lock (maybe_reopen) and rebuild their index
  // from the fresh file. Returns bytes reclaimed, or -1 on IO failure.
  long compact() {
    Guard g(this);
    struct stat st_old;
    if (fstat(log_fd_, &st_old) != 0) return -1;
    const std::string tmp_path = dir_ + "/trials.log.tmp";
    int tmp_fd = ::open(tmp_path.c_str(),
                        O_CREAT | O_TRUNC | O_WRONLY, 0666);
    if (tmp_fd < 0) return -1;
    // the rewritten log is a NEW history: fresh epoch so every held
    // fetch_since cursor invalidates (forcing one safe full refetch)
    const uint64_t new_epoch = random_epoch();
    std::string out(kMagic2, sizeof(kMagic2));
    out.append(reinterpret_cast<const char*>(&new_epoch),
               sizeof(new_epoch));
    for (const auto& key : order_) {
      auto it = index_.find(key);
      if (it == index_.end()) continue;
      const Entry& e = it->second;
      append_record(out, Record{1, key, e.status, "", e.payload, e.order});
      append_record(out, Record{3, key, "", e.worker, "", e.heartbeat});
    }
    bool ok = ::write(tmp_fd, out.data(), out.size()) ==
              static_cast<ssize_t>(out.size());
    ok = ok && ::fsync(tmp_fd) == 0;
    ::close(tmp_fd);
    if (!ok) {
      ::unlink(tmp_path.c_str());
      return -1;
    }
    if (::rename(tmp_path.c_str(), (dir_ + "/trials.log").c_str()) != 0) {
      ::unlink(tmp_path.c_str());
      return -1;
    }
    // our own fd still points at the replaced inode — reopen and mark the
    // whole fresh file as applied (index_ already reflects it)
    ::close(log_fd_);
    log_fd_ = ::open((dir_ + "/trials.log").c_str(),
                     O_CREAT | O_RDWR | O_APPEND, 0666);
    if (log_fd_ < 0) return -1;
    applied_ = out.size();
    epoch_ = new_epoch;
    // re-derive seqs as a FRESH replayer of the rewritten log would
    // (two records per live key, in order_ order) — cursor consistency
    // across processes depends on every handle agreeing on (epoch, seq)
    seq_ = 0;
    completed_events_.clear();  // seqs changed; rebuild sorted (below)
    for (const auto& key : order_) {
      auto it = index_.find(key);
      if (it == index_.end()) continue;
      seq_ += 2;
      it->second.last_seq = seq_;
      if (it->second.status == "completed")
        completed_events_.push_back({seq_, key});
    }
    // a log of pure put records can legally GROW slightly (two records per
    // key after compaction): that is still success, not an IO failure —
    // report zero reclaimed rather than a negative the caller would treat
    // as an error
    long saved = static_cast<long>(st_old.st_size) -
                 static_cast<long>(out.size());
    return saved > 0 ? saved : 0;
  }

 private:
  static std::vector<std::string> split_csv(const char* csv) {
    std::vector<std::string> out;
    if (!csv || !csv[0]) return out;
    const char* p = csv;
    while (*p) {
      const char* q = strchr(p, ',');
      if (!q) q = p + strlen(p);
      if (q > p) out.emplace_back(p, q - p);
      p = *q ? q + 1 : q;
    }
    return out;
  }

  static bool contains(const std::vector<std::string>& v,
                       const std::string& s) {
    for (const auto& x : v)
      if (x == s) return true;
    return false;
  }

  std::string envelope(const std::string& key, const Entry& e) const {
    // key/status/worker are quote/backslash-free by wrapper contract;
    // payload is raw JSON and embedded verbatim.
    std::string out = "{\"key\":\"" + key + "\",\"status\":\"" + e.status +
                      "\",\"worker\":\"" + e.worker + "\",\"heartbeat\":";
    char buf[32];
    snprintf(buf, sizeof(buf), "%.6f", e.heartbeat);
    out += buf;
    out += ",\"payload\":";
    out += e.payload.empty() ? "null" : e.payload;
    out += "}";
    return out;
  }

  // ---- log IO ----
  static void put_u16(std::string& b, uint16_t v) {
    b.append(reinterpret_cast<const char*>(&v), 2);
  }
  static void put_u32(std::string& b, uint32_t v) {
    b.append(reinterpret_cast<const char*>(&v), 4);
  }
  static void put_str16(std::string& b, const std::string& s) {
    put_u16(b, static_cast<uint16_t>(s.size()));
    b += s;
  }

  static void append_record(std::string& out, const Record& r) {
    std::string body;
    body.push_back(static_cast<char>(r.op));
    put_str16(body, r.key);
    put_str16(body, r.status);
    put_str16(body, r.worker);
    body.append(reinterpret_cast<const char*>(&r.heartbeat), 8);
    put_u32(body, static_cast<uint32_t>(r.payload.size()));
    body += r.payload;
    put_u32(out, static_cast<uint32_t>(body.size()));
    out += body;
  }

  bool append(const Record& r) {
    if (foreign_) return false;  // never write into an unknown format
    std::string rec;
    append_record(rec, r);
    ssize_t n = ::write(log_fd_, rec.data(), rec.size());
    if (n != static_cast<ssize_t>(rec.size())) return false;
    applied_ += rec.size();
    return true;
  }

  // A compaction by another process replaced the log inode: reopen from
  // the path and rebuild from scratch (caller holds the lock; replay_tail
  // right after this repopulates the index from the fresh file).
  void maybe_reopen() {
    struct stat st_fd, st_path;
    if (fstat(log_fd_, &st_fd) != 0) return;
    if (::stat((dir_ + "/trials.log").c_str(), &st_path) != 0) return;
    if (st_fd.st_ino == st_path.st_ino && st_fd.st_dev == st_path.st_dev)
      return;
    ::close(log_fd_);
    log_fd_ = ::open((dir_ + "/trials.log").c_str(),
                     O_CREAT | O_RDWR | O_APPEND, 0666);
    index_.clear();
    order_.clear();
    clear_indexes();
    seq_ = 0;  // fresh log = fresh epoch: seqs restart with the replay
    foreign_ = false;  // the replacement may be OURS again
    read_or_init_header();
  }

  void apply(const Record& r) {
    // every applied record advances the log clock — deterministic across
    // processes because all replay the identical record stream
    ++seq_;
    if (r.op == 5) {  // wipe: the log's "delete everything" tombstone
      index_.clear();
      order_.clear();
      clear_indexes();
      return;
    }
    if (r.op == 1) {
      if (index_.count(r.key)) return;  // insert-only
      index_[r.key] =
          Entry{r.status, r.worker, 0.0, r.heartbeat, r.payload, seq_};
      order_.push_back(r.key);
      index_add(r.key, index_.at(r.key), seq_);
      return;
    }
    auto it = index_.find(r.key);
    if (it == index_.end()) return;  // mark/beat for unknown key: ignore
    Entry& e = it->second;
    index_remove(it->first, e);
    e.last_seq = seq_;
    if (r.op == 2) {
      e.status = r.status;
      e.worker = r.worker;
      e.heartbeat = r.heartbeat;
      e.payload = r.payload;
    } else if (r.op == 3) {
      if (!r.status.empty()) e.status = r.status;
      e.worker = r.worker;
      e.heartbeat = r.heartbeat;
    } else if (r.op == 4) {
      e.heartbeat = r.heartbeat;
    }
    index_add(it->first, e, seq_);
  }

  // Replay records other processes appended since our last look. Truncates
  // a torn tail (crash mid-write) so the log stays parseable.
  void replay_tail() {
    if (foreign_) return;  // never parse (or "repair") an unknown format
    struct stat st;
    if (fstat(log_fd_, &st) != 0) return;
    if (static_cast<off_t>(applied_) >= st.st_size) return;
    size_t len = st.st_size - applied_;
    std::string buf(len, '\0');
    ssize_t n = ::pread(log_fd_, buf.data(), len, applied_);
    if (n < 0) return;
    buf.resize(n);

    size_t pos = 0;
    while (pos + 4 <= buf.size()) {
      uint32_t body_len;
      memcpy(&body_len, buf.data() + pos, 4);
      if (body_len > (64u << 20)) {
        // no legal record is 64MB: this is NOT a torn tail but bytes in
        // a format we don't understand (e.g. a newer log header read by
        // an older build) — truncating would destroy the store. Stop
        // parsing and leave the file alone.
        break;
      }
      if (pos + 4 + body_len > buf.size()) {
        // torn tail — drop it (holder of the exclusive lock may truncate)
        if (::ftruncate(log_fd_, applied_ + pos) == 0) {
          applied_ += pos;
          return;
        }
        break;
      }
      const char* p = buf.data() + pos + 4;
      const char* end = p + body_len;
      Record r;
      if (!parse(p, end, &r)) break;
      apply(r);
      pos += 4 + body_len;
    }
    applied_ += pos;
  }

  static bool get_str16(const char*& p, const char* end, std::string* out) {
    if (p + 2 > end) return false;
    uint16_t n;
    memcpy(&n, p, 2);
    p += 2;
    if (p + n > end) return false;
    out->assign(p, n);
    p += n;
    return true;
  }

  static bool parse(const char* p, const char* end, Record* r) {
    if (p >= end) return false;
    r->op = static_cast<uint8_t>(*p++);
    if (!get_str16(p, end, &r->key) || !get_str16(p, end, &r->status) ||
        !get_str16(p, end, &r->worker))
      return false;
    if (p + 8 > end) return false;
    memcpy(&r->heartbeat, p, 8);
    p += 8;
    if (p + 4 > end) return false;
    uint32_t plen;
    memcpy(&plen, p, 4);
    p += 4;
    if (p + plen > end) return false;
    r->payload.assign(p, plen);
    return true;
  }

  std::string dir_;
  int lock_fd_ = -1;
  int log_fd_ = -1;
  size_t applied_ = 0;  // log bytes reflected in the index
  uint64_t seq_ = 0;    // applied-record count: the log's logical clock
  uint64_t epoch_ = 0;  // this log file's identity (fetch_since cursors)
  bool foreign_ = false;  // log format unknown: read-as-empty, no writes
  std::unordered_map<std::string, Entry> index_;
  std::vector<std::string> order_;  // insertion order, for FIFO reserve
  // Derived indexes, maintained by apply() so every op that scanned the
  // whole entry map is O(1)/O(log n). At 10k trials the O(n) scans made
  // the per-trial cost linear in history (count alone was a third of a
  // 10k sweep's wall time); these keep the coordination plane flat.
  std::unordered_map<std::string, long> status_counts_;
  std::set<std::pair<double, std::string>> new_set_;       // (order, key)
  std::set<std::pair<double, std::string>> reserved_set_;  // (heartbeat, key)
  // (seq, key) appended whenever a record leaves an entry 'completed';
  // possibly duplicated per key (re-marks) — readers dedup
  std::vector<std::pair<uint64_t, std::string>> completed_events_;

  void index_remove(const std::string& key, const Entry& e) {
    auto c = status_counts_.find(e.status);
    if (c != status_counts_.end() && --(c->second) <= 0)
      status_counts_.erase(c);
    if (e.status == "new") new_set_.erase({e.order, key});
    else if (e.status == "reserved") reserved_set_.erase({e.heartbeat, key});
  }

  void index_add(const std::string& key, const Entry& e, uint64_t seq) {
    ++status_counts_[e.status];
    if (e.status == "new") new_set_.insert({e.order, key});
    else if (e.status == "reserved") reserved_set_.insert({e.heartbeat, key});
    else if (e.status == "completed") completed_events_.push_back({seq, key});
  }

  void clear_indexes() {
    status_counts_.clear();
    new_set_.clear();
    reserved_set_.clear();
    completed_events_.clear();
  }
};

char* dup_or_null(const std::string& s) {
  if (s.empty()) return nullptr;
  char* out = static_cast<char*>(malloc(s.size() + 1));
  if (out) memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

extern "C" {

void* ls_open(const char* dir) {
  Store* s = new Store(dir);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

void ls_close(void* h) { delete static_cast<Store*>(h); }

int ls_put(void* h, const char* key, const char* status, const char* payload,
           double sort_key) {
  return static_cast<Store*>(h)->put(key, status, payload, sort_key);
}

int ls_cas(void* h, const char* key, const char* exp_status,
           const char* exp_worker, const char* new_status,
           const char* new_worker, const char* new_payload, double hb) {
  return static_cast<Store*>(h)->cas(key, exp_status, exp_worker, new_status,
                                     new_worker, new_payload, hb);
}

char* ls_reserve(void* h, const char* worker) {
  return dup_or_null(static_cast<Store*>(h)->reserve(worker));
}

int ls_heartbeat(void* h, const char* key, const char* worker) {
  return static_cast<Store*>(h)->beat(key, worker);
}

char* ls_release_stale(void* h, double timeout_s) {
  return dup_or_null(static_cast<Store*>(h)->release_stale(timeout_s));
}

char* ls_get(void* h, const char* key) {
  return dup_or_null(static_cast<Store*>(h)->get(key));
}

char* ls_fetch(void* h, const char* status_csv) {
  return dup_or_null(static_cast<Store*>(h)->fetch(status_csv));
}

char* ls_fetch_since(void* h, const char* status_csv,
                     unsigned long long epoch, unsigned long long seq) {
  return dup_or_null(
      static_cast<Store*>(h)->fetch_since(status_csv, epoch, seq));
}

long ls_count(void* h, const char* status_csv) {
  return static_cast<Store*>(h)->count(status_csv);
}

long ls_compact(void* h) { return static_cast<Store*>(h)->compact(); }

int ls_wipe(void* h) { return static_cast<Store*>(h)->wipe(); }

void ls_free(char* p) { free(p); }

}  // extern "C"
