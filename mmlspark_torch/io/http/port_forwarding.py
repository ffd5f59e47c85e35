"""Port forwarding — reach serving endpoints across network boundaries.

Reference ``io/http/PortForwarding.scala``: jsch-managed SSH sessions with
keep-alive and retry, used to expose worker servers running inside
VNETs/Databricks to external clients.

Two implementations:

- :class:`SshTunnel` — manages an ``ssh -N -L/-R`` subprocess with the
  reference's session options (keep-alive interval, auto-reconnect,
  retry-with-backoff on start). Gated on an ``ssh`` binary being present.
- :class:`TcpForwarder` — a dependency-free threaded TCP relay for
  same-trust-domain forwarding (and for testing the forwarding contract
  without an SSH daemon).
"""

from __future__ import annotations

import shutil
import socket
import subprocess
import threading
import time

from ...core.utils import retry_with_timeout


class TcpForwarder:
    """Threaded local TCP relay: ``localhost:local_port`` → ``target``."""

    def __init__(self, target_host: str, target_port: int,
                 local_host: str = "127.0.0.1", local_port: int = 0,
                 backlog: int = 32):
        self.target = (target_host, target_port)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((local_host, local_port))
        self._listener.listen(backlog)
        self.local_address = self._listener.getsockname()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)

    def start(self) -> "TcpForwarder":
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            try:
                upstream = socket.create_connection(self.target, timeout=10)
            except OSError:
                client.close()
                continue
            for a, b in ((client, upstream), (upstream, client)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    @staticmethod
    def _pump(src: socket.socket, dst: socket.socket):
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass


class SshTunnel:
    """An ``ssh`` forwarding subprocess with the reference's session
    hygiene (``PortForwarding.scala``: keep-alive, retry on start,
    re-establish on death)."""

    def __init__(self, bastion: str, *, local_port: int,
                 remote_host: str = "127.0.0.1", remote_port: int,
                 reverse: bool = False, user: str | None = None,
                 key_file: str | None = None,
                 keepalive_s: int = 30, connect_timeout_s: int = 10):
        self.bastion = f"{user}@{bastion}" if user else bastion
        self.spec = (f"{remote_port}:{remote_host}:{local_port}" if reverse
                     else f"{local_port}:{remote_host}:{remote_port}")
        self.reverse = reverse
        self.key_file = key_file
        self.keepalive_s = keepalive_s
        self.connect_timeout_s = connect_timeout_s
        self._proc: subprocess.Popen | None = None
        self._stop = threading.Event()

    @staticmethod
    def available() -> bool:
        return shutil.which("ssh") is not None

    def command(self) -> list[str]:
        """The ssh invocation (exposed for inspection/testing)."""
        cmd = ["ssh", "-N", "-R" if self.reverse else "-L", self.spec,
               "-o", f"ServerAliveInterval={self.keepalive_s}",
               "-o", "ServerAliveCountMax=3",
               "-o", f"ConnectTimeout={self.connect_timeout_s}",
               "-o", "ExitOnForwardFailure=yes",
               "-o", "StrictHostKeyChecking=accept-new",
               "-o", "BatchMode=yes"]
        if self.key_file:
            cmd += ["-i", self.key_file]
        cmd.append(self.bastion)
        return cmd

    def start(self) -> "SshTunnel":
        if not self.available():
            raise RuntimeError(
                "no `ssh` binary on PATH — SshTunnel needs an OpenSSH "
                "client; use TcpForwarder for same-host relaying")

        def launch():
            proc = subprocess.Popen(self.command(),
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE)
            time.sleep(0.2)
            if proc.poll() is not None:
                err = (proc.stderr.read() or b"").decode("utf-8", "replace")
                raise RuntimeError(f"ssh tunnel died on start: {err[:500]}")
            return proc

        self._proc = retry_with_timeout(launch, backoffs_ms=(0, 500, 2000))
        threading.Thread(target=self._keepalive_loop, daemon=True).start()
        return self

    def _keepalive_loop(self):
        while not self._stop.wait(1.0):
            if self._proc is not None and self._proc.poll() is not None:
                try:  # re-establish a dropped tunnel (reference retry)
                    self._proc = subprocess.Popen(
                        self.command(), stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
