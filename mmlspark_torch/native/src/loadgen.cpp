// Native HTTP load generator for the serving benches.
//
// The serving bench's loaded rows drive N keep-alive connections in a
// closed loop. A Python http.client worker holds the GIL for every
// request it sends — at 16-way that caps the CLIENT's rate and the
// measurement reports the load generator, not the server (and the
// client threads steal the GIL from the very server they measure).
// This is the classic reason load tests use wrk/ab; this is the
// minimal equivalent, with no dependency: one OS thread per
// connection, blocking sockets with SO_RCVTIMEO/SO_SNDTIMEO (a server
// that accepts but never replies becomes a transport failure, not a
// thread the bench watchdog cannot kill), TCP_NODELAY, strict
// request-response (no pipelining), per-request wall latency recorded.
//
// Counterpart of the reference's perf narrative for its serving layer
// (docs/mmlspark-serving.md "sub-millisecond latency"); no reference
// source equivalent — its load tests ran external tooling.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cctype>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct ConnResult {
  long errors = 0;   // non-200 responses or transport failures
  bool hard_fail = false;
};

// Per-operation I/O deadline. Applied as SO_RCVTIMEO/SO_SNDTIMEO so a
// recv/send against a stalled server fails (EAGAIN) instead of
// blocking forever; on Linux SO_SNDTIMEO also bounds connect(). A
// timeout surfaces through the existing n<=0 transport-failure paths.
constexpr long kIoTimeoutSec = 5;

int connect_to(const char* host, int port) {
  // getaddrinfo so hostnames ('localhost') work, not just IPv4
  // literals — an unresolvable host is a failed connection, never a
  // silent fallthrough.
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  const std::string service = std::to_string(port);
  if (::getaddrinfo(host, service.c_str(), &hints, &res) != 0 ||
      res == nullptr)
    return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    timeval tv{};
    tv.tv_sec = kIoTimeoutSec;
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  return fd;
}

bool send_all(int fd, const char* buf, size_t len) {
  while (len > 0) {
    ssize_t n = ::send(fd, buf, len, 0);
    if (n <= 0) return false;
    buf += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Case-insensitive scan for a numeric header value within [pos, end).
// Returns the parsed value or `fallback` when the header is absent.
double scan_numeric_header(const std::string& buf, size_t header_end,
                           const char* name, size_t name_len,
                           double fallback) {
  for (size_t pos = 0; pos < header_end;) {
    size_t eol = buf.find("\r\n", pos);
    if (eol == std::string::npos || eol > header_end) eol = header_end;
    if (eol - pos > name_len) {
      bool match = true;
      for (size_t i = 0; i < name_len; ++i)
        if (std::tolower(buf[pos + i]) != name[i]) { match = false; break; }
      if (match) return std::strtod(buf.c_str() + pos + name_len, nullptr);
    }
    pos = eol + 2;
  }
  return fallback;
}

// Read one HTTP/1.1 response; returns status code or -1 on transport
// error. Handles Content-Length bodies (the serving fronts always set
// it); `carry` holds bytes read past the current response (defensive —
// strict request-response means there should be none). `retry_after_s`,
// when non-null, receives the Retry-After header in seconds (0 when
// absent) — the sched subsystem's 429/503 sheds always set it.
// `t_first`, when non-null, receives the time the FIRST byte of this
// response arrived (generation mode: a streaming-shaped server sends
// headers as soon as the first token exists, so first-byte time is the
// client-observed TTFT; carried-over bytes count as immediate).
int read_response(int fd, std::string& carry,
                  double* retry_after_s = nullptr,
                  Clock::time_point* t_first = nullptr) {
  std::string buf = std::move(carry);
  carry.clear();
  bool got_first = !buf.empty();
  if (got_first && t_first) *t_first = Clock::now();
  char tmp[8192];
  size_t header_end;
  while ((header_end = buf.find("\r\n\r\n")) == std::string::npos) {
    ssize_t n = ::recv(fd, tmp, sizeof(tmp), 0);
    if (n <= 0) return -1;
    if (!got_first) {
      got_first = true;
      if (t_first) *t_first = Clock::now();
    }
    buf.append(tmp, static_cast<size_t>(n));
  }
  int status = -1;
  if (buf.size() >= 12 && buf.compare(0, 5, "HTTP/") == 0)
    status = std::atoi(buf.c_str() + 9);
  size_t clen = static_cast<size_t>(scan_numeric_header(
      buf, header_end, "content-length:", 15, 0.0));
  if (retry_after_s)
    *retry_after_s = scan_numeric_header(buf, header_end,
                                         "retry-after:", 12, 0.0);
  size_t need = header_end + 4 + clen;
  while (buf.size() < need) {
    ssize_t n = ::recv(fd, tmp, sizeof(tmp), 0);
    if (n <= 0) return -1;
    buf.append(tmp, static_cast<size_t>(n));
  }
  if (buf.size() > need) carry = buf.substr(need);
  return status;
}

// Cap on how long a Retry-After instruction is honored: the bench's
// retry exists to measure the shed/retry contract, not to park a
// closed-loop thread for a server-chosen eternity.
constexpr double kMaxRetryAfterSec = 2.0;

// Per-request W3C-style traceparent header: trace id =
// <prefix><conn:4hex><req:8hex>, so the Python summary can RECONSTRUCT
// the trace id of any (connection, request) slot — the p99-slowest
// requests become flight-recorder lookup keys without shipping ids
// back through the FFI.
std::string trace_header(const std::string& prefix, int conn, long req) {
  char buf[64];
  std::snprintf(buf, sizeof(buf), "%04x%08lx", conn,
                static_cast<unsigned long>(req));
  return "Traceparent: 00-" + prefix + buf + "-0001-01\r\n";
}

void run_conn(const char* host, int port, const std::string& head,
              const std::string& body, const std::string& trace_prefix,
              const std::string& tenant_header, int conn_idx, long nreq,
              int retry_shed, double* lat_ms, int* status_out,
              double* ttft_ms, ConnResult* res) {
  int fd = connect_to(host, port);
  if (fd < 0) {
    res->hard_fail = true;
    res->errors = nreq;
    for (long i = 0; i < nreq; ++i) {
      lat_ms[i] = -1.0;
      if (status_out) status_out[i] = -1;
      if (ttft_ms) ttft_ms[i] = -1.0;
    }
    return;
  }
  std::string carry;
  // the tenant header is fixed PER CONNECTION (lg_run5): one closed
  // loop = one tenant, so the Python summary can split percentiles and
  // shed counts per tenant from connection-major matrices alone
  std::string request = head + tenant_header + "\r\n" + body;
  for (long i = 0; i < nreq; ++i) {
    if (!trace_prefix.empty())
      request = head + tenant_header
          + trace_header(trace_prefix, conn_idx, i) + "\r\n" + body;
    auto t0 = Clock::now();
    auto tf = t0;
    int status = -1;
    double retry_after = 0.0;
    if (send_all(fd, request.data(), request.size()))
      status = read_response(fd, carry, &retry_after,
                             ttft_ms ? &tf : nullptr);
    auto t1 = Clock::now();
    bool retried = false;
    if (retry_shed && (status == 429 || status == 503)) {
      // honor the shed's Retry-After with ONE bounded re-attempt;
      // the recorded latency is the re-attempt's round trip (the
      // back-off wait is the server's instruction, not its latency).
      // Same traceparent: one logical request, one trace.
      double wait = retry_after > 0 ? retry_after : 0.05;
      if (wait > kMaxRetryAfterSec) wait = kMaxRetryAfterSec;
      timespec ts;
      ts.tv_sec = static_cast<time_t>(wait);
      ts.tv_nsec = static_cast<long>((wait - ts.tv_sec) * 1e9);
      ::nanosleep(&ts, nullptr);
      t0 = Clock::now();
      tf = t0;
      status = -1;
      if (send_all(fd, request.data(), request.size()))
        status = read_response(fd, carry, nullptr,
                               ttft_ms ? &tf : nullptr);
      t1 = Clock::now();
      retried = true;
    }
    // transport failures record -1, NOT time-until-failure: a dead
    // server fails sends at once, and near-zero "latencies" would
    // otherwise pollute the percentiles and count as completions.
    // Non-200 HTTP replies are real round trips — latency stands,
    // error counted; the per-request status lets the Python side
    // separate sheds (429) from successes instead of folding them.
    // A retried request reports status + 1000 (e.g. 1200 = 200 on
    // the bounded re-attempt), so retry traffic stays distinguishable
    // from first-offer load in the summary.
    lat_ms[i] = status < 0 ? -1.0
        : std::chrono::duration<double, std::milli>(t1 - t0).count();
    // TTFT mirrors the latency conventions: -1 on transport failure,
    // and a retried request reports the re-attempt's first byte (same
    // reasoning — the back-off wait is the server's instruction).
    if (ttft_ms)
      ttft_ms[i] = status < 0 ? -1.0
          : std::chrono::duration<double, std::milli>(tf - t0).count();
    if (status_out)
      status_out[i] = (retried && status >= 0) ? status + 1000 : status;
    if (status != 200) {
      ++res->errors;
      if (status < 0) {  // transport death: reconnect once, else bail
        ::close(fd);
        fd = connect_to(host, port);
        if (fd < 0) {
          for (long j = i + 1; j < nreq; ++j) {
            lat_ms[j] = -1.0;
            if (status_out) status_out[j] = -1;
            if (ttft_ms) ttft_ms[j] = -1.0;
          }
          res->errors += nreq - i - 1;
          res->hard_fail = true;
          return;
        }
        carry.clear();
      }
    }
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// Drive `nconn` keep-alive connections of `nreq` serial POSTs each.
// lat_ms must hold nconn*nreq doubles (connection-major; failed slots
// are -1); status_out, when non-null, receives the per-request HTTP
// status (-1 = transport failure) so the caller can split successes
// from sheds (429) and errors instead of folding them into one number.
// retry_shed != 0 honors Retry-After on 429/503 with one bounded
// re-attempt; such requests report status + 1000 (1200 = 200 on the
// re-attempt) so retry traffic is distinguishable from first-offer
// load. trace_prefix, when non-empty, stamps every request with a
// deterministic traceparent (<prefix><conn:4hex><req:8hex>) so outliers
// can be looked up in the server's flight recorder. tenants, when
// non-empty, is a comma-separated list: connection c stamps
// "X-Tenant: <tenants[c % n]>" on every request (one tenant per
// connection, so the Python summary can split its per-tenant columns
// from connection-major matrices). ttft_ms, when non-null, must hold
// nconn*nreq doubles (connection-major) and receives each request's
// time-to-first-byte — the generation-mode TTFT: an LLM serving front
// answers when the first token exists, so first-byte time is what a
// client perceives as time-to-first-token (-1 on transport failure; a
// retried request reports the re-attempt's first byte, matching
// lat_ms). Returns total non-200/transport errors, or -1 when every
// connection failed to even connect.
long lg_run6(const char* host, int port, int nconn, long nreq,
             const char* path, const unsigned char* body, long body_len,
             int retry_shed, const char* trace_prefix,
             const char* tenants, double* lat_ms, int* status_out,
             double* ttft_ms, double* wall_s) {
  // head stops before the blank line: the per-connection X-Tenant and
  // per-request traceparent (and the terminating \r\n) are appended
  // per connection/send
  std::string head;
  head.reserve(256);
  head += "POST ";
  head += path;
  head += " HTTP/1.1\r\nHost: bench\r\nContent-Length: ";
  head += std::to_string(body_len);
  head += "\r\nConnection: keep-alive\r\n";
  std::string payload(reinterpret_cast<const char*>(body),
                      static_cast<size_t>(body_len));
  std::string prefix(trace_prefix ? trace_prefix : "");
  std::vector<std::string> tenant_headers;
  if (tenants && tenants[0]) {
    std::string list(tenants);
    size_t pos = 0;
    while (pos <= list.size()) {
      size_t comma = list.find(',', pos);
      if (comma == std::string::npos) comma = list.size();
      if (comma > pos)
        tenant_headers.push_back(
            "X-Tenant: " + list.substr(pos, comma - pos) + "\r\n");
      pos = comma + 1;
    }
  }
  if (tenant_headers.empty()) tenant_headers.push_back("");

  std::vector<ConnResult> results(static_cast<size_t>(nconn));
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nconn));
  auto t0 = Clock::now();
  for (int c = 0; c < nconn; ++c)
    threads.emplace_back(run_conn, host, port, std::cref(head),
                         std::cref(payload), std::cref(prefix),
                         std::cref(tenant_headers[
                             static_cast<size_t>(c)
                             % tenant_headers.size()]),
                         c, nreq, retry_shed,
                         lat_ms + static_cast<long>(c) * nreq,
                         status_out ? status_out
                             + static_cast<long>(c) * nreq : nullptr,
                         ttft_ms ? ttft_ms
                             + static_cast<long>(c) * nreq : nullptr,
                         &results[static_cast<size_t>(c)]);
  for (auto& t : threads) t.join();
  auto t1 = Clock::now();
  if (wall_s) *wall_s = std::chrono::duration<double>(t1 - t0).count();

  long errors = 0;
  int hard = 0;
  for (auto& r : results) {
    errors += r.errors;
    hard += r.hard_fail ? 1 : 0;
  }
  if (hard == nconn) return -1;
  return errors;
}

// Back-compat entry point (no time-to-first-byte reporting).
long lg_run5(const char* host, int port, int nconn, long nreq,
             const char* path, const unsigned char* body, long body_len,
             int retry_shed, const char* trace_prefix,
             const char* tenants, double* lat_ms, int* status_out,
             double* wall_s) {
  return lg_run6(host, port, nconn, nreq, path, body, body_len,
                 retry_shed, trace_prefix, tenants, lat_ms, status_out,
                 nullptr, wall_s);
}

// Back-compat entry point (no per-connection X-Tenant stamping).
long lg_run4(const char* host, int port, int nconn, long nreq,
             const char* path, const unsigned char* body, long body_len,
             int retry_shed, const char* trace_prefix, double* lat_ms,
             int* status_out, double* wall_s) {
  return lg_run5(host, port, nconn, nreq, path, body, body_len,
                 retry_shed, trace_prefix, "", lat_ms, status_out,
                 wall_s);
}

// Back-compat entry point (no traceparent stamping).
long lg_run3(const char* host, int port, int nconn, long nreq,
             const char* path, const unsigned char* body, long body_len,
             int retry_shed, double* lat_ms, int* status_out,
             double* wall_s) {
  return lg_run4(host, port, nconn, nreq, path, body, body_len,
                 retry_shed, "", lat_ms, status_out, wall_s);
}

// Back-compat entry point (no Retry-After re-attempts).
long lg_run2(const char* host, int port, int nconn, long nreq,
             const char* path, const unsigned char* body, long body_len,
             double* lat_ms, int* status_out, double* wall_s) {
  return lg_run3(host, port, nconn, nreq, path, body, body_len, 0,
                 lat_ms, status_out, wall_s);
}

// Back-compat entry point (no per-request statuses).
long lg_run(const char* host, int port, int nconn, long nreq,
            const char* path, const unsigned char* body, long body_len,
            double* lat_ms, double* wall_s) {
  return lg_run2(host, port, nconn, nreq, path, body, body_len, lat_ms,
                 nullptr, wall_s);
}

}  // extern "C"
