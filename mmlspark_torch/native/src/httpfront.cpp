// Native HTTP serving front: a single-reactor epoll server with a
// C ABI for ctypes.
//
// Role of the reference's per-executor WorkerServer HTTP listener
// (continuous/HTTPSourceV2.scala:475+), rebuilt as native code for the
// serving hot path: the Python http.server front costs a thread per
// connection plus several GIL hand-offs per request, which is where the
// serving tail latency (p99) lives. Here one reactor thread owns all
// sockets; Python sees only (id, method, path, body) tuples via a
// polling call and replies by id.
//
// ABI (all thread-safe):
//   hf_start(host, port, &out_port)      -> handle (>0) or -errno
//   hf_poll(h, ids, max_n, timeout_ms)   -> n ready request ids
//   hf_req_info(h, id, meth, mcap, path, pcap, &body_len, &hdr_len)
//   hf_req_body(h, id, buf)              -> body_len copied
//   hf_req_headers(h, id, buf)           -> raw header bytes copied
//   hf_reply(h, id, status, extra_hdr_lines, body, len) -> 0
//   hf_stop(h)
//
// Requests are parsed HTTP/1.1 with keep-alive and pipelining; replies
// are single-writev responses with Connection: keep-alive. TCP_NODELAY
// is set on every accepted socket (the Nagle/delayed-ACK stall class —
// see serving/server.py LowLatencyHandlerMixin).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>

namespace {

struct Conn {
    int fd;
    uint64_t gen;        // accept generation: guards fd-reuse delivery
    std::string in;      // unparsed bytes
    std::string out;     // unflushed response bytes
    bool closing = false;
    // One request in flight at a time: replies are generated in
    // completion order (the pipeline may answer out of order), so
    // parsing the next pipelined request only after the current one's
    // response is queued keeps per-connection response order correct.
    bool in_flight = false;
};

struct Req {
    uint64_t id;
    int conn_fd;         // owning connection (may die before reply)
    uint64_t conn_gen;   // must match Conn.gen at delivery time
    std::string method, path, headers_raw, body;
    bool keepalive = true;
};

struct Server {
    int listen_fd = -1, epoll_fd = -1, event_fd = -1;
    ~Server() {
        if (event_fd >= 0) ::close(event_fd);
        if (epoll_fd >= 0) ::close(epoll_fd);
    }
    std::thread loop;
    std::atomic<bool> stop{false};

    std::mutex mu;
    std::condition_variable cv;
    std::deque<uint64_t> ready;                    // ids awaiting poll
    std::unordered_map<uint64_t, Req> reqs;        // in flight
    std::deque<std::pair<uint64_t, std::string>> replies;  // id, raw bytes
    uint64_t next_id = 1;
    uint64_t next_gen = 1;

    std::unordered_map<int, Conn> conns;           // reactor-thread only
};

std::mutex g_mu;
std::unordered_map<int64_t, std::shared_ptr<Server>> g_servers;
int64_t g_next_handle = 1;

void flush_out(Server& s, Conn& c);

constexpr size_t kMaxHeaderBytes = 64 * 1024;
constexpr size_t kMaxBodyBytes = size_t(64) << 20;  // 64 MiB
// hard per-connection buffer cap, enforced in the recv path regardless
// of parse state — an in-flight request must not suspend flood control
constexpr size_t kMaxConnBuffer = kMaxBodyBytes + 2 * kMaxHeaderBytes;

bool parse_one(Conn& c, Server& s) {
    // returns true if a complete request was consumed from c.in
    if (c.in_flight) return false;  // strict request-at-a-time per conn
    size_t hdr_end = c.in.find("\r\n\r\n");
    if (hdr_end == std::string::npos) {
        if (c.in.size() > kMaxHeaderBytes) {  // header flood: drop conn
            c.closing = true;
            c.in.clear();
        }
        return false;
    }
    size_t line_end = c.in.find("\r\n");
    std::string line = c.in.substr(0, line_end);
    size_t sp1 = line.find(' '), sp2 = line.rfind(' ');
    if (sp1 == std::string::npos || sp2 <= sp1) {  // malformed: drop conn
        c.closing = true;
        c.in.clear();
        return false;
    }
    std::string method = line.substr(0, sp1);
    std::string path = line.substr(sp1 + 1, sp2 - sp1 - 1);

    size_t clen = 0;
    bool keepalive = true;
    size_t pos = line_end + 2;
    while (pos < hdr_end) {
        size_t eol = c.in.find("\r\n", pos);
        std::string h = c.in.substr(pos, eol - pos);
        pos = eol + 2;
        size_t colon = h.find(':');
        if (colon == std::string::npos) continue;
        std::string key = h.substr(0, colon);
        for (auto& ch : key) ch = (char)tolower((unsigned char)ch);
        std::string val = h.substr(colon + 1);
        size_t b = val.find_first_not_of(' ');
        val = (b == std::string::npos) ? "" : val.substr(b);
        if (key == "content-length") {
            // reject negatives (would wrap) and unbounded bodies
            if (val.empty() || val[0] == '-' ||
                val.find_first_not_of("0123456789") != std::string::npos) {
                c.closing = true;
                c.in.clear();
                return false;
            }
            clen = (size_t)strtoull(val.c_str(), nullptr, 10);
            if (clen > kMaxBodyBytes) {
                // explicit 413 before close: an abrupt reset would look
                // like a network fault and get retried forever. Only
                // BUFFERED here — flush_out can close and erase the
                // Conn, and our caller still holds the reference.
                c.out += "HTTP/1.1 413 Payload Too Large\r\n"
                         "Content-Length: 0\r\nConnection: close\r\n\r\n";
                c.closing = true;
                c.in.clear();
                return false;
            }
        }
        if (key == "connection") {
            for (auto& ch : val) ch = (char)tolower((unsigned char)ch);
            if (val == "close") keepalive = false;
        }
    }
    size_t total = hdr_end + 4 + clen;
    if (c.in.size() < total) return false;  // body not yet complete

    Req r;
    r.conn_fd = c.fd;
    r.conn_gen = c.gen;
    r.method = std::move(method);
    r.path = std::move(path);
    r.headers_raw = c.in.substr(line_end + 2, hdr_end - line_end - 2);
    r.body = c.in.substr(hdr_end + 4, clen);
    r.keepalive = keepalive;
    c.in.erase(0, total);
    c.in_flight = true;
    {
        std::lock_guard<std::mutex> lk(s.mu);
        r.id = s.next_id++;
        uint64_t id = r.id;
        s.reqs.emplace(id, std::move(r));
        s.ready.push_back(id);
    }
    s.cv.notify_one();
    return true;
}

void flush_out(Server& s, Conn& c) {
    while (!c.out.empty()) {
        ssize_t w = ::send(c.fd, c.out.data(), c.out.size(), MSG_NOSIGNAL);
        if (w > 0) {
            c.out.erase(0, (size_t)w);
        } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            epoll_event ev{};
            ev.events = EPOLLIN | EPOLLOUT;
            ev.data.fd = c.fd;
            epoll_ctl(s.epoll_fd, EPOLL_CTL_MOD, c.fd, &ev);
            return;
        } else {
            c.closing = true;
            return;
        }
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = c.fd;
    epoll_ctl(s.epoll_fd, EPOLL_CTL_MOD, c.fd, &ev);
    if (c.closing) {  // close-after-flush (Connection: close)
        epoll_ctl(s.epoll_fd, EPOLL_CTL_DEL, c.fd, nullptr);
        ::close(c.fd);
        s.conns.erase(c.fd);
    }
}

void close_conn(Server& s, int fd) {
    epoll_ctl(s.epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
    ::close(fd);
    s.conns.erase(fd);
}

void reactor(Server* s) {
    epoll_event evs[64];
    while (!s->stop.load(std::memory_order_relaxed)) {
        int n = epoll_wait(s->epoll_fd, evs, 64, 100);
        for (int i = 0; i < n; i++) {
            int fd = evs[i].data.fd;
            if (fd == s->listen_fd) {
                for (;;) {
                    int cfd = accept4(s->listen_fd, nullptr, nullptr,
                                      SOCK_NONBLOCK);
                    if (cfd < 0) break;
                    int one = 1;
                    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one,
                               sizeof one);
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.fd = cfd;
                    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
                    Conn c{};
                    c.fd = cfd;
                    c.gen = s->next_gen++;
                    s->conns[cfd] = std::move(c);
                }
                continue;
            }
            if (fd == s->event_fd) {
                uint64_t junk;
                while (read(s->event_fd, &junk, 8) == 8) {}
                // drain pending replies into connection buffers
                std::deque<std::pair<uint64_t, std::string>> pending;
                struct Target { int fd; uint64_t gen; bool keepalive; };
                std::deque<Target> target;
                {
                    std::lock_guard<std::mutex> lk(s->mu);
                    pending.swap(s->replies);
                    for (auto& pr : pending) {
                        auto it = s->reqs.find(pr.first);
                        if (it == s->reqs.end()) {
                            target.push_back({-1, 0, true});
                        } else {
                            target.push_back({it->second.conn_fd,
                                              it->second.conn_gen,
                                              it->second.keepalive});
                            s->reqs.erase(it);
                        }
                    }
                }
                for (size_t k = 0; k < pending.size(); k++) {
                    auto it = s->conns.find(target[k].fd);
                    // generation check: a reused fd number is a
                    // DIFFERENT client — never deliver across reuse
                    if (it == s->conns.end() ||
                        it->second.gen != target[k].gen)
                        continue;  // client gone
                    Conn& c = it->second;
                    c.out += pending[k].second;
                    if (!target[k].keepalive) c.closing = true;
                    flush_out(*s, c);
                    // response queued: this connection may now parse its
                    // next buffered (pipelined) request
                    if (s->conns.find(target[k].fd) != s->conns.end()) {
                        c.in_flight = false;
                        while (parse_one(c, *s)) {}
                        if (!c.out.empty()) flush_out(*s, c);
                        auto it2 = s->conns.find(target[k].fd);
                        if (it2 != s->conns.end() && it2->second.closing
                            && it2->second.out.empty())
                            close_conn(*s, target[k].fd);
                    }
                }
                continue;
            }
            auto it = s->conns.find(fd);
            if (it == s->conns.end()) continue;
            Conn& c = it->second;
            if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
                close_conn(*s, fd);
                continue;
            }
            if (evs[i].events & EPOLLOUT) flush_out(*s, c);
            if (s->conns.find(fd) == s->conns.end()) continue;
            if (evs[i].events & EPOLLIN) {
                char buf[65536];
                for (;;) {
                    ssize_t r = ::recv(fd, buf, sizeof buf, 0);
                    if (r > 0) {
                        c.in.append(buf, (size_t)r);
                        if (c.in.size() > kMaxConnBuffer) {
                            close_conn(*s, fd);
                            break;
                        }
                    } else if (r == 0) {  // peer closed
                        close_conn(*s, fd);
                        break;
                    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
                        break;
                    } else {
                        close_conn(*s, fd);
                        break;
                    }
                }
                if (s->conns.find(fd) != s->conns.end()) {
                    while (parse_one(c, *s)) {}
                    if (!c.out.empty()) flush_out(*s, c);
                    // flush_out may have closed + erased: re-look-up
                    auto it2 = s->conns.find(fd);
                    if (it2 != s->conns.end() && it2->second.closing &&
                        it2->second.out.empty())
                        close_conn(*s, fd);
                }
            }
        }
    }
}

std::shared_ptr<Server> get(int64_t h) {
    // shared_ptr: a caller mid-hf_reply keeps the Server alive across a
    // concurrent hf_stop (stop closes sockets; memory lives until the
    // last caller returns)
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_servers.find(h);
    return it == g_servers.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t hf_start(const char* host, int port, int* out_port) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -errno;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        ::close(fd);
        return -EINVAL;
    }
    if (bind(fd, (sockaddr*)&addr, sizeof addr) < 0 ||
        listen(fd, 1024) < 0) {
        int e = errno;
        ::close(fd);
        return -e;
    }
    socklen_t alen = sizeof addr;
    getsockname(fd, (sockaddr*)&addr, &alen);
    if (out_port) *out_port = (int)ntohs(addr.sin_port);

    auto sp = std::make_shared<Server>();
    Server* s = sp.get();
    s->listen_fd = fd;
    s->epoll_fd = epoll_create1(0);
    s->event_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, fd, &ev);
    ev.data.fd = s->event_fd;
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->event_fd, &ev);
    s->loop = std::thread(reactor, s);

    std::lock_guard<std::mutex> lk(g_mu);
    int64_t h = g_next_handle++;
    g_servers[h] = sp;
    return h;
}

int64_t hf_poll(int64_t h, uint64_t* ids, int64_t max_n, int timeout_ms) {
    auto s = get(h);
    if (!s) return -1;
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->ready.empty())
        s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                       [&] { return !s->ready.empty(); });
    int64_t n = 0;
    while (n < max_n && !s->ready.empty()) {
        ids[n++] = s->ready.front();
        s->ready.pop_front();
    }
    return n;
}

int hf_req_info(int64_t h, uint64_t id, char* method, int64_t mcap,
                char* path, int64_t pcap, int64_t* body_len,
                int64_t* headers_len) {
    auto s = get(h);
    if (!s) return -1;
    std::lock_guard<std::mutex> lk(s->mu);
    auto it = s->reqs.find(id);
    if (it == s->reqs.end()) return -1;
    snprintf(method, (size_t)mcap, "%s", it->second.method.c_str());
    snprintf(path, (size_t)pcap, "%s", it->second.path.c_str());
    *body_len = (int64_t)it->second.body.size();
    *headers_len = (int64_t)it->second.headers_raw.size();
    return 0;
}

int64_t hf_req_headers(int64_t h, uint64_t id, char* buf) {
    auto s = get(h);
    if (!s) return -1;
    std::lock_guard<std::mutex> lk(s->mu);
    auto it = s->reqs.find(id);
    if (it == s->reqs.end()) return -1;
    memcpy(buf, it->second.headers_raw.data(),
           it->second.headers_raw.size());
    return (int64_t)it->second.headers_raw.size();
}

int64_t hf_req_body(int64_t h, uint64_t id, char* buf) {
    auto s = get(h);
    if (!s) return -1;
    std::lock_guard<std::mutex> lk(s->mu);
    auto it = s->reqs.find(id);
    if (it == s->reqs.end()) return -1;
    memcpy(buf, it->second.body.data(), it->second.body.size());
    return (int64_t)it->second.body.size();
}

int hf_reply(int64_t h, uint64_t id, int status, const char* extra_hdrs,
             const char* body, int64_t len) {
    // extra_hdrs: zero or more pre-formatted "Key: Value\r\n" lines
    // (the pipeline's response headers, minus the reserved ones below)
    auto s = get(h);
    if (!s) return -1;
    std::string resp;
    {
        std::lock_guard<std::mutex> lk(s->mu);
        auto it = s->reqs.find(id);
        if (it == s->reqs.end()) return -1;  // already answered / gone
        bool ka = it->second.keepalive;
        char hdr[128];
        int hl = snprintf(hdr, sizeof hdr, "HTTP/1.1 %d %s\r\n",
                          status, status < 400 ? "OK" : "Error");
        resp.assign(hdr, (size_t)hl);
        if (extra_hdrs && *extra_hdrs) resp += extra_hdrs;
        hl = snprintf(hdr, sizeof hdr,
                      "Content-Length: %lld\r\nConnection: %s\r\n\r\n",
                      (long long)len, ka ? "keep-alive" : "close");
        resp.append(hdr, (size_t)hl);
        resp.append(body, (size_t)len);
        s->replies.emplace_back(id, std::move(resp));
    }
    uint64_t one = 1;
    ssize_t ignored = write(s->event_fd, &one, 8);
    (void)ignored;
    return 0;
}

void hf_stop(int64_t h) {
    std::shared_ptr<Server> s;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_servers.find(h);
        if (it == g_servers.end()) return;
        s = it->second;
        g_servers.erase(it);
    }
    s->stop.store(true);
    uint64_t one = 1;
    ssize_t ignored = write(s->event_fd, &one, 8);
    (void)ignored;
    s->loop.join();
    for (auto& kv : s->conns) ::close(kv.first);
    ::close(s->listen_fd);
    // epoll_fd / event_fd close in ~Server when the last concurrent
    // hf_reply/hf_poll holding a shared_ptr returns — a racing write to
    // event_fd must hit the (dead) eventfd, never a reused fd number
}

}  // extern "C"
