"""``python -m sentinel_tpu_torch.dashboard`` — run the dashboard standalone."""

import argparse
import time

from sentinel_tpu_torch.dashboard.server import DashboardServer


def main() -> None:
    ap = argparse.ArgumentParser(description="sentinel-tpu dashboard")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args()
    server = DashboardServer(host=args.host, port=args.port).start()
    print(f"sentinel-tpu dashboard on http://{args.host}:{server.bound_port}/")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
