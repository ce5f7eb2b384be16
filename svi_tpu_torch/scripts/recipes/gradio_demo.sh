#!/bin/bash
# Launch the SVI gradio demo with the port (PyTorch on the card): the options
# of scripts/gradio_demo.sh (mode, port, share, DiT root) plus --npy, which
# writes the videos as .npy arrays where no mp4 writer is installed. Run from
# the repository's root; gradio must be installed.
set -e
cd "$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)"

MODE=film
PORT=7860
SHARE=""
SAVE_FORMAT=mp4
DIT_ROOT="weights/Wan2.1-I2V-14B-480P/"

usage() {
  cat <<USAGE
Usage: $0 [options]
  -h, --help        Show this help
  -p, --port PORT   Server port (default: 7860)
  -s, --share       Enable gradio public sharing
  --dit PATH        DiT model root directory
  --film            Start in SVI-Film mode (default)
  --shot            Start in SVI-Shot mode
  --npy             Write videos as .npy (T, H, W, 3) uint8 arrays
USAGE
}

while [[ $# -gt 0 ]]; do
  case "$1" in
    -h|--help) usage; exit 0 ;;
    -p|--port) PORT="$2"; shift 2 ;;
    -s|--share) SHARE="--share"; shift ;;
    --dit) DIT_ROOT="$2"; shift 2 ;;
    --film) MODE=film; shift ;;
    --shot) MODE=shot; shift ;;
    --npy) SAVE_FORMAT=npy; shift ;;
    *) echo "unknown option: $1"; usage; exit 1 ;;
  esac
done

command -v python >/dev/null || { echo "python not found"; exit 1; }
python -c "import gradio" 2>/dev/null || { echo "gradio not installed"; exit 1; }
[ -d "$DIT_ROOT" ] || echo "warning: DiT root '$DIT_ROOT' not found — demo will fail to load weights"

exec python -m svi_tpu_torch.scripts.gradio_demo \
  --mode "$MODE" --server_port "$PORT" --dit_root "$DIT_ROOT" --save_format "$SAVE_FORMAT" $SHARE
