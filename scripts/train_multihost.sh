#!/bin/bash
# Multi-host GPU launch (SLURM or any scheduler), with auto-resume.
#
# Replacement for the reference's torchrun sbatch scripts
# (run_desta_qwen3_4b.sbatch:69-81): one copy of this script runs per
# host, driving all of that host's GPUs from one process;
# jax.distributed joins the hosts through JAX_COORDINATOR_ADDRESS /
# JAX_NUM_PROCESSES / JAX_PROCESS_ID (set from SLURM vars below when
# present; set them yourself under another scheduler).
#
# SLURM usage: srun --ntasks-per-node=1 bash scripts/train_multihost.sh
set -euo pipefail

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
cd "$REPO_DIR"

CONFIG=${CONFIG:-configs/desta25_llama31-8B_Qformer6L.yaml}
DATASET=${DATASET:-DestaAQA-5M}
OUTPUT_ROOT=${OUTPUT_ROOT:-exp}
EXP_SUFFIX=${EXP_SUFFIX:-flagship}
DATA_ROOT=${DATA_ROOT:-/data}

# --- scheduler env -> jax.distributed env (SLURM multi-node case) --------
if [ -n "${SLURM_JOB_ID:-}" ] && [ "${SLURM_NNODES:-1}" -gt 1 ]; then
    export JAX_COORDINATOR_ADDRESS=${JAX_COORDINATOR_ADDRESS:-"$(scontrol \
        show hostnames "$SLURM_JOB_NODELIST" | head -n1):8476"}
    export JAX_NUM_PROCESSES=${JAX_NUM_PROCESSES:-$SLURM_NNODES}
    export JAX_PROCESS_ID=${JAX_PROCESS_ID:-$SLURM_NODEID}
fi

# --- auto-resume: newest run with a checkpoint-latest symlink -------------
# (reference ablation_sbatch/exp0_baseline.sbatch:36-44 behavior)
resume_args=""
latest_dir=$(ls -td "${OUTPUT_ROOT}"/*_"${EXP_SUFFIX}" 2>/dev/null | head -n1 || true)
if [ -d "${latest_dir:-}/checkpoint-latest" ]; then
    echo "Resuming: $latest_dir"
    exp_dir="$latest_dir"
    resume_args="resume_from_checkpoint=$latest_dir"
else
    exp_dir="${OUTPUT_ROOT}/$(date +%y%m%d-%H%M)_${EXP_SUFFIX}"
    echo "New experiment: $exp_dir"
fi
mkdir -p "$exp_dir"

# provenance capture (reference train_qwen3_4b.sh:47-49)
if [ "${JAX_PROCESS_ID:-0}" = "0" ]; then
    git rev-parse HEAD > "$exp_dir/git_commit.txt" 2>/dev/null || true
    git diff > "$exp_dir/git_diff.txt" 2>/dev/null || true
    pip list > "$exp_dir/pip_list.txt" 2>/dev/null || true
fi

export JAX_COMPILATION_CACHE_DIR="${JAX_COMPILATION_CACHE_DIR:-$REPO_DIR/.jax_cache}"

exec python -m desta25_audio_tpu.cli.train --config "$CONFIG" \
    +dataset="$DATASET" \
    exp_dir="$exp_dir" \
    dataset.data_root="$DATA_ROOT" \
    $resume_args "$@"
