#!/usr/bin/env bash
# N local CPU processes of the multi-process demo (multihost_demo.py): the
# process group over gloo, the ('map', 'kf') mesh over every rank of every
# process, and the map-sharded mapping program across process boundaries.
# Arguments are passed on to every process; PORT and N set the coordinator's
# port and the number of processes. On a machine with cards, run
# `python -m niceslam_tpu_torch.multihost_demo` without --cpu once per host.
set -euo pipefail
cd "$(dirname "$0")/.."

PORT="${PORT:-9876}"
N="${N:-2}"

pids=()
for ((i=1; i<N; i++)); do
  python -m niceslam_tpu_torch.multihost_demo --cpu \
    --num-processes "$N" --process-id "$i" --coordinator "localhost:$PORT" "$@" &
  pids+=($!)
done
python -m niceslam_tpu_torch.multihost_demo --cpu \
  --num-processes "$N" --process-id 0 --coordinator "localhost:$PORT" "$@"
for p in "${pids[@]}"; do wait "$p"; done
echo "multihost cpu validation: OK ($N processes)" >&2
