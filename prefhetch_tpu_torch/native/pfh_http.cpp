// Copy of native/pfh_http.cpp, the JAX package's epoll frontend, left
// unchanged: the port builds its own library from it at first use
// (prefhetch_tpu_torch/native/__init__.py) and drives it from
// prefhetch_tpu_torch/serve/native_server.py.
//
// Native epoll HTTP/1.1 frontend for the serving hot path.
//
// The reference serves from Drogon's epoll event loop
// (reference: src/server/server_lib.cpp:48-53 — Drogon app().run() with
// handler threads). The TPU rebuild's equivalent must solve a harder
// problem on a one-core host: per-REQUEST Python work (socket handling,
// HTTP parse, dispatcher, batcher futures) measured ~5 ms/request and
// capped serving at ~85 q/s against a ~20K q/s device pipeline. This
// frontend moves every per-request byte-shuffle into C++ and exposes a
// per-BATCH interface to Python:
//
//   pfh_http_start(port)            — epoll thread owns all sockets
//   pfh_http_poll(h, out, max, first_wait_us, grace_us)
//       blocks for the first parsed request, then drains arrivals until
//       `grace_us` of silence (or max reqs) — the cross-request batching
//       window runs HERE, not in Python
//   pfh_http_respond(h, req_id, status, ctype, body, len)
//       queues the response; the epoll thread writes it out
//
// Python's serving loop (serve/native_server.py) therefore runs ONCE per
// batch: group requests by route/shape, one engine call, N respond()s.
//
// Protocol scope: HTTP/1.1 keep-alive, Content-Length bodies (chunked
// gets 501), responses written in per-connection request order (safe
// under client pipelining even though batching may complete out of
// order). Anything beyond the hot binary routes is passed up unchanged —
// Python's Dispatcher remains the semantic authority for every route.

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <strings.h>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
#include <condition_variable>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kMaxHeader = 64 * 1024;
constexpr size_t kMaxBody = 1ull << 30;
constexpr int kPathMax = 120;

struct Request {
    uint64_t req_id;
    uint64_t conn_id;
    uint64_t seq;            // per-connection order
    char method[8];
    char path[kPathMax];
    uint8_t flags;           // 1 = binary content-type, 2 = accept-binary
    std::vector<uint8_t> body;
};

// descriptor handed to Python (mirrors serve/native_server.py ctypes)
struct ReqDesc {
    uint64_t req_id;
    const uint8_t* body;
    uint64_t body_len;
    char method[8];
    char path[kPathMax];
    uint8_t flags;
};

struct PendingResp {
    bool ready = false;
    std::string data;        // full HTTP bytes
};

struct Conn {
    int fd = -1;
    uint64_t id = 0;
    std::string inbuf;
    // parse state: 0 = headers, 1 = body
    int state = 0;
    size_t body_need = 0;
    Request cur;
    uint64_t next_seq = 0;       // next request sequence to assign
    uint64_t write_seq = 0;      // next sequence to write out
    std::map<uint64_t, PendingResp> pending;  // seq -> response
    std::string outbuf;          // bytes currently being written
    bool closing = false;
};

struct Server {
    int listen_fd = -1;
    int epoll_fd = -1;
    int event_fd = -1;
    std::thread io_thread;
    std::atomic<bool> stop{false};

    std::mutex mu;
    std::condition_variable cv;
    std::deque<Request*> ready;              // parsed, waiting for Python

    // responses queued by Python, consumed by the IO thread
    std::mutex resp_mu;
    std::vector<std::pair<uint64_t, std::string>> resp_queue;

    std::unordered_map<uint64_t, Conn*> conns;
    // req_id -> (conn_id, seq); only touched on the IO thread
    std::unordered_map<uint64_t, std::pair<uint64_t, uint64_t>> req_map;
    std::mutex req_map_mu;
    uint64_t next_conn_id = 2;   // 0 = listen socket tag, 1 = eventfd tag
    uint64_t next_req_id = 1;

    // requests handed to Python and not yet responded: their body memory
    // must stay alive until respond()
    std::mutex inflight_mu;
    std::unordered_map<uint64_t, Request*> inflight;
};

void set_nonblock(int fd) {
    // (fcntl-free: SOCK_NONBLOCK on accept4/socket covers every fd here)
}

const char* status_line(int code) {
    switch (code) {
        case 200: return "HTTP/1.1 200 OK\r\n";
        case 400: return "HTTP/1.1 400 Bad Request\r\n";
        case 404: return "HTTP/1.1 404 Not Found\r\n";
        case 405: return "HTTP/1.1 405 Method Not Allowed\r\n";
        case 409: return "HTTP/1.1 409 Conflict\r\n";
        case 501: return "HTTP/1.1 501 Not Implemented\r\n";
        default:  return "HTTP/1.1 500 Internal Server Error\r\n";
    }
}

const char* ctype_str(int ctype) {
    switch (ctype) {
        case 1: return "application/x-prefhetch-bin";
        default: return "application/json";
    }
}

std::string build_response(int status, int ctype, const uint8_t* body,
                           uint64_t len) {
    std::string out;
    out.reserve(len + 128);
    out += status_line(status);
    out += "Content-Type: ";
    out += ctype_str(ctype);
    out += "\r\nContent-Length: ";
    out += std::to_string(len);
    out += "\r\nConnection: keep-alive\r\n\r\n";
    out.append(reinterpret_cast<const char*>(body), len);
    return out;
}

// case-insensitive header find inside [buf, buf+len); returns value
// (trimmed) or empty
std::string find_header(const char* buf, size_t len, const char* name) {
    size_t nlen = strlen(name);
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        // the final header line's "\r\n" belongs to the "\r\n\r\n" block
        // PAST `len`, so the last segment has no '\n' inside the window —
        // treat end-of-window as its terminator
        const char* eol = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!eol) eol = end;
        size_t ll = static_cast<size_t>(eol - p);
        if (ll > nlen && strncasecmp(p, name, nlen) == 0 && p[nlen] == ':') {
            const char* v = p + nlen + 1;
            const char* ve = eol;
            while (v < ve && (*v == ' ' || *v == '\t')) ++v;
            while (ve > v && (ve[-1] == '\r' || ve[-1] == ' ')) --ve;
            return std::string(v, ve);
        }
        p = eol + 1;
    }
    return "";
}

void close_conn(Server* s, Conn* c) {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    s->conns.erase(c->id);
    delete c;
}

void queue_error(Server* s, Conn* c, int status, const char* msg) {
    std::string body = std::string("{\"error\": \"") + msg + "\"}";
    std::string resp = build_response(
        status, 0, reinterpret_cast<const uint8_t*>(body.data()),
        body.size());
    uint64_t seq = c->next_seq++;
    auto& pr = c->pending[seq];
    pr.ready = true;
    pr.data = std::move(resp);
}

// pump completed responses (in per-connection order) into the out buffer
// and write as much as the socket takes
void flush_conn(Server* s, Conn* c) {
    for (;;) {
        if (c->outbuf.empty()) {
            auto it = c->pending.find(c->write_seq);
            if (it == c->pending.end() || !it->second.ready) break;
            c->outbuf = std::move(it->second.data);
            c->pending.erase(it);
            ++c->write_seq;
        }
        while (!c->outbuf.empty()) {
            ssize_t n = send(c->fd, c->outbuf.data(), c->outbuf.size(),
                             MSG_NOSIGNAL);
            if (n > 0) {
                c->outbuf.erase(0, static_cast<size_t>(n));
            } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
                // wait for EPOLLOUT
                epoll_event ev{};
                ev.events = EPOLLIN | EPOLLOUT;
                ev.data.u64 = c->id;
                epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
                return;
            } else {
                close_conn(s, c);
                return;
            }
        }
    }
    // nothing left to write: stop watching EPOLLOUT
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = c->id;
    epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
    if (c->closing && c->pending.empty() && c->outbuf.empty())
        close_conn(s, c);
}

// returns false if the connection died
bool parse_conn(Server* s, Conn* c) {
    for (;;) {
        if (c->closing) return true;  // drain only; no further parsing
        if (c->state == 0) {
            size_t hdr_end = c->inbuf.find("\r\n\r\n");
            if (hdr_end == std::string::npos) {
                if (c->inbuf.size() > kMaxHeader) {
                    close_conn(s, c);
                    return false;
                }
                return true;  // need more bytes
            }
            const char* buf = c->inbuf.data();
            // request line: METHOD SP PATH SP HTTP/1.1
            const char* sp1 = static_cast<const char*>(
                memchr(buf, ' ', hdr_end));
            if (!sp1) { close_conn(s, c); return false; }
            const char* sp2 = static_cast<const char*>(
                memchr(sp1 + 1, ' ', hdr_end - (sp1 + 1 - buf)));
            if (!sp2) { close_conn(s, c); return false; }
            Request& r = c->cur;
            size_t mlen = std::min<size_t>(sp1 - buf, sizeof(r.method) - 1);
            memcpy(r.method, buf, mlen);
            r.method[mlen] = 0;
            size_t plen = std::min<size_t>(sp2 - (sp1 + 1), kPathMax - 1);
            memcpy(r.path, sp1 + 1, plen);
            r.path[plen] = 0;

            std::string te = find_header(buf, hdr_end, "Transfer-Encoding");
            std::string cl = find_header(buf, hdr_end, "Content-Length");
            std::string ct = find_header(buf, hdr_end, "Content-Type");
            std::string ac = find_header(buf, hdr_end, "Accept");
            r.flags = 0;
            if (ct.find("application/x-prefhetch-bin") != std::string::npos)
                r.flags |= 1;
            if (ac.find("application/x-prefhetch-bin") != std::string::npos)
                r.flags |= 2;
            c->inbuf.erase(0, hdr_end + 4);
            if (!te.empty() && te != "identity") {
                queue_error(s, c, 501, "chunked transfer not supported");
                flush_conn(s, c);
                c->closing = true;
                return true;
            }
            size_t need = 0;
            if (!cl.empty()) {
                char* endp = nullptr;
                unsigned long long v = strtoull(cl.c_str(), &endp, 10);
                if (endp == cl.c_str() || v > kMaxBody) {
                    close_conn(s, c);
                    return false;
                }
                need = static_cast<size_t>(v);
            }
            c->body_need = need;
            c->state = 1;
        }
        if (c->state == 1) {
            if (c->inbuf.size() < c->body_need) return true;  // more bytes
            Request* r = new Request(std::move(c->cur));
            c->cur = Request{};
            r->body.assign(c->inbuf.begin(),
                           c->inbuf.begin() +
                               static_cast<ptrdiff_t>(c->body_need));
            c->inbuf.erase(0, c->body_need);
            c->state = 0;
            r->conn_id = c->id;
            r->seq = c->next_seq++;
            c->pending[r->seq];  // reserve the ordering slot
            {
                std::lock_guard<std::mutex> lk(s->mu);
                r->req_id = s->next_req_id++;
                s->req_map[r->req_id] = {r->conn_id, r->seq};
                s->ready.push_back(r);
            }
            s->cv.notify_one();
        }
    }
}

void io_loop(Server* s) {
    epoll_event evs[64];
    while (!s->stop.load(std::memory_order_relaxed)) {
        int n = epoll_wait(s->epoll_fd, evs, 64, 200);
        if (n < 0) {
            if (errno == EINTR) continue;
            break;
        }
        for (int i = 0; i < n; ++i) {
            uint64_t tag = evs[i].data.u64;
            if (tag == 0) {  // listen socket
                for (;;) {
                    int fd = accept4(s->listen_fd, nullptr, nullptr,
                                     SOCK_NONBLOCK);
                    if (fd < 0) break;
                    int one = 1;
                    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one,
                               sizeof(one));
                    Conn* c = new Conn();
                    c->fd = fd;
                    c->id = s->next_conn_id++;
                    s->conns[c->id] = c;
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.u64 = c->id;
                    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, fd, &ev);
                }
                continue;
            }
            if (tag == 1) {  // eventfd: responses queued by Python
                uint64_t junk;
                while (read(s->event_fd, &junk, 8) == 8) {}
                std::vector<std::pair<uint64_t, std::string>> batch;
                {
                    std::lock_guard<std::mutex> lk(s->resp_mu);
                    batch.swap(s->resp_queue);
                }
                for (auto& [req_id, data] : batch) {
                    std::pair<uint64_t, uint64_t> loc;
                    {
                        std::lock_guard<std::mutex> lk(s->req_map_mu);
                        auto it = s->req_map.find(req_id);
                        if (it == s->req_map.end()) continue;
                        loc = it->second;
                        s->req_map.erase(it);
                    }
                    auto cit = s->conns.find(loc.first);
                    if (cit == s->conns.end()) continue;  // conn died
                    Conn* c = cit->second;
                    auto pit = c->pending.find(loc.second);
                    if (pit == c->pending.end()) continue;
                    pit->second.ready = true;
                    pit->second.data = std::move(data);
                    flush_conn(s, c);
                }
                continue;
            }
            auto cit = s->conns.find(tag);
            if (cit == s->conns.end()) continue;
            Conn* c = cit->second;
            if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
                close_conn(s, c);
                continue;
            }
            if (evs[i].events & EPOLLOUT) flush_conn(s, c);
            // flush_conn may have closed it
            if (s->conns.find(tag) == s->conns.end()) continue;
            if (evs[i].events & EPOLLIN) {
                char buf[65536];
                for (;;) {
                    ssize_t r = recv(c->fd, buf, sizeof(buf), 0);
                    if (r > 0) {
                        c->inbuf.append(buf, static_cast<size_t>(r));
                        if (c->inbuf.size() > kMaxBody + kMaxHeader) {
                            close_conn(s, c);
                            c = nullptr;
                            break;
                        }
                    } else if (r == 0) {
                        // peer closed; parse what we have, then drop
                        close_conn(s, c);
                        c = nullptr;
                        break;
                    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
                        break;
                    } else {
                        close_conn(s, c);
                        c = nullptr;
                        break;
                    }
                }
                if (c && !parse_conn(s, c)) continue;
            }
        }
    }
}

}  // namespace

extern "C" {

void* pfh_http_start(uint16_t port, int backlog) {
    Server* s = new Server();
    s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (s->listen_fd < 0) { delete s; return nullptr; }
    int one = 1;
    setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(port);
    if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) < 0 ||
        listen(s->listen_fd, backlog > 0 ? backlog : 128) < 0) {
        close(s->listen_fd);
        delete s;
        return nullptr;
    }
    s->epoll_fd = epoll_create1(0);
    s->event_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = 0;
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
    epoll_event ev2{};
    ev2.events = EPOLLIN;
    ev2.data.u64 = 1;
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->event_fd, &ev2);
    s->io_thread = std::thread(io_loop, s);
    return s;
}

// Blocks up to first_wait_us for the first request, then keeps draining
// until `grace_us` passes with no arrival (or max_n reached) — the
// cross-request batching window. Returns the number of descriptors
// filled; their body pointers stay valid until pfh_http_respond.
int pfh_http_poll(void* h, ReqDesc* out, int max_n, int64_t first_wait_us,
                  int64_t grace_us) {
    Server* s = static_cast<Server*>(h);
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->ready.empty()) {
        s->cv.wait_for(lk, std::chrono::microseconds(first_wait_us),
                       [&] { return !s->ready.empty() || s->stop.load(); });
    }
    int n = 0;
    while (n < max_n) {
        while (!s->ready.empty() && n < max_n) {
            Request* r = s->ready.front();
            s->ready.pop_front();
            ReqDesc& d = out[n++];
            d.req_id = r->req_id;
            d.body = r->body.data();
            d.body_len = r->body.size();
            memcpy(d.method, r->method, sizeof(d.method));
            memcpy(d.path, r->path, sizeof(d.path));
            d.flags = r->flags;
            std::lock_guard<std::mutex> ilk(s->inflight_mu);
            s->inflight[r->req_id] = r;
        }
        if (n >= max_n || n == 0 || grace_us <= 0) break;
        // grace window: wait for stragglers
        bool more = s->cv.wait_for(
            lk, std::chrono::microseconds(grace_us),
            [&] { return !s->ready.empty() || s->stop.load(); });
        if (!more || s->stop.load()) break;
    }
    return n;
}

void pfh_http_respond(void* h, uint64_t req_id, int status, int ctype,
                      const uint8_t* body, uint64_t len) {
    Server* s = static_cast<Server*>(h);
    std::string resp = build_response(status, ctype, body, len);
    {
        std::lock_guard<std::mutex> lk(s->inflight_mu);
        auto it = s->inflight.find(req_id);
        if (it != s->inflight.end()) {
            delete it->second;      // request body no longer needed
            s->inflight.erase(it);
        }
    }
    {
        std::lock_guard<std::mutex> lk(s->resp_mu);
        s->resp_queue.emplace_back(req_id, std::move(resp));
    }
    uint64_t one = 1;
    ssize_t wr = write(s->event_fd, &one, 8);
    (void)wr;
}

// Bulk respond: n responses whose bodies are consecutive slices of `buf`
// (body i = buf[offsets[i], offsets[i+1])), all sharing one content type.
// One GIL-released ctypes transition, two lock acquisitions, and ONE
// eventfd wake replace n of each — the per-request syscall/FFI cost was a
// measurable slice of the serving wave on a one-core host.
void pfh_http_respond_multi(void* h, int n, const uint64_t* req_ids,
                            const int* statuses, int ctype,
                            const uint8_t* buf, const uint64_t* offsets) {
    Server* s = static_cast<Server*>(h);
    std::vector<std::pair<uint64_t, std::string>> batch;
    batch.reserve(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) {
        batch.emplace_back(
            req_ids[i],
            build_response(statuses[i], ctype, buf + offsets[i],
                           offsets[i + 1] - offsets[i]));
    }
    {
        std::lock_guard<std::mutex> lk(s->inflight_mu);
        for (int i = 0; i < n; ++i) {
            auto it = s->inflight.find(req_ids[i]);
            if (it != s->inflight.end()) {
                delete it->second;
                s->inflight.erase(it);
            }
        }
    }
    {
        std::lock_guard<std::mutex> lk(s->resp_mu);
        for (auto& pr : batch)
            s->resp_queue.emplace_back(pr.first, std::move(pr.second));
    }
    uint64_t one = 1;
    ssize_t wr = write(s->event_fd, &one, 8);
    (void)wr;
}

uint16_t pfh_http_port(void* h) {
    Server* s = static_cast<Server*>(h);
    sockaddr_in addr{};
    socklen_t alen = sizeof(addr);
    getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    return ntohs(addr.sin_port);
}

void pfh_http_stop(void* h) {
    Server* s = static_cast<Server*>(h);
    s->stop.store(true);
    s->cv.notify_all();
    uint64_t one = 1;
    ssize_t wr = write(s->event_fd, &one, 8);
    (void)wr;
    if (s->io_thread.joinable()) s->io_thread.join();
    for (auto& [id, c] : s->conns) {
        close(c->fd);
        delete c;
    }
    s->conns.clear();
    {
        std::lock_guard<std::mutex> lk(s->mu);
        for (Request* r : s->ready) delete r;
        s->ready.clear();
    }
    {
        std::lock_guard<std::mutex> lk(s->inflight_mu);
        for (auto& [id, r] : s->inflight) delete r;
        s->inflight.clear();
    }
    close(s->listen_fd);
    close(s->epoll_fd);
    close(s->event_fd);
    delete s;
}

}  // extern "C"
