#!/bin/bash
# The study's long runs on one H100, through the port's CLIs:
#
#   bash runscripts_torch/study.sh MBPO_STEPS SAC_STEPS [OUT [RUN...]]
#
# First MBPO runs of runscripts/mbpo_ks.sh's arguments to MBPO_STEPS env
# steps, each a process of its own, all at once on the one card:
#   seed2, seed3   --solver pallas --seed 2 / 3 (K1);
#   bf16           runscripts/mbpo_ks_bf16.sh's additions (K2 at bf16_3x);
#   dissipation    runscripts/mbpo_ks_dissipation.sh's addition, objective ""
#                  (K1);
#   latent         runscripts/mbpo_ks_latent_r4.sh's overrides (the
#                  KSLatentConvolutionalLSTM family, 750 steps and patience
#                  10 a retrain) and --solver pallas (K1);
#   burgers        runscripts/mbpo_burgers.sh: BurgersEnv-v0 at
#                  --reward_scale 500, its other arguments mbpo_ks.sh's
#                  (no kernel); its runscript stops at 20,000 env steps.
# RUN... names the runs (the first four by default); any of them runs alone
# at any MBPO_STEPS, as `study.sh 50000 0 OUT dissipation` does.  Then the
# SAC baseline to
# SAC_STEPS env steps on both reward channels, seeds 0 and 1, four processes
# at once, each at its JAX stream's cadence: l2control as results/sac500k
# (warmup 5,000, an evaluation every 10,000 steps), dissipation as
# results/sac500k_dissipation (the defaults: warmup 20,000, an evaluation
# every 2,000 steps); one update per env step, K1.
#
# 0 skips a group.  The processes of a group are dealt out over the visible
# cards in turn.  Processes that share a card take it in turns: four MBPO
# runs on one H100 took 3.4 times as long as one alone.  Each run
# writes OUT/<name>/ and OUT/<name>.log, and loses its snapshots (371 MB
# each) and all but its first and last evaluation npz at the end.  OUT
# defaults to chiprun_out/study.
set -u
cd "$(dirname "$0")/.."
MBPO_STEPS=${1:?MBPO_STEPS}
SAC_STEPS=${2:?SAC_STEPS}
OUT=${3:-chiprun_out/study}
shift $(($# < 3 ? $# : 3))
RUNS=${*:-seed2 seed3 bf16 dissipation}
mkdir -p "$OUT"
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-2}

echo "[study] nproc $(nproc)"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print("[study]", sys.version.split()[0], torch.__version__, torch.version.cuda)'

trap 'pkill -P $$ 2>/dev/null' EXIT

MBPO=(python -m pdecontrol_tpu_torch.mbrl.script
    --env_id KuramotoSivashinskyEnv-v0
    --factory KSAutoRegConvolutionalLSTM
    --training '{"tau": 5, "initial": {"tbtt": 10, "patience": 10, "batch_size": 64}, "iterations": {"tbtt": 10, "patience": 5, "batch_size": 64}}'
    --trainer '{"initial": {"min_steps": 250, "max_steps": 2000}, "iterations": {"min_steps": 50, "max_steps": 250}}'
    --curriculum '{"scheduler": "LinearScheduler", "steptype": "iteration", "start": 0, "stop": 10, "vmin": 15, "vmax": 15}'
    --loss MSELoss
    --learning_starts 5000
    --rollout_length_schedule '{"scheduler": "LinearScheduler", "steptype": "iteration", "start": 0, "stop": 200, "vmin": 3, "vmax": 7}'
    --policy_train_steps_per_sample 10
    --surrogate_train_freq 500
    --checkpoint_freq 200
    --total_timesteps "$MBPO_STEPS")
SAC=(python -m pdecontrol_tpu_torch.sac.train --total_timesteps "$SAC_STEPS")

# prune DIR: drop the snapshots and the evaluation npz of every iteration but
# the first and the last.
prune() {
    rm -rf "$1/checkpoints"
    [ -d "$1/evaluation" ] || return 0
    local its first last
    its=$(find "$1/evaluation" -name '*.npz' | sed 's/.*_\([0-9]*\)\.npz$/\1/' | sort -n | uniq)
    first=$(echo "$its" | head -n 1)
    last=$(echo "$its" | tail -n 1)
    find "$1/evaluation" -name '*.npz' ! -name "*_${first}.npz" ! -name "*_${last}.npz" -delete
}

# launch NAME COMMAND...: one run in the background on the next card, timed.
CARDS=$(nvidia-smi -L | wc -l)
PIDS=()
launch() {
    local name=$1; shift
    local card=$(( ${#PIDS[@]} % (CARDS > 0 ? CARDS : 1) ))
    (
        export CUDA_VISIBLE_DEVICES=$card
        start=$(date +%s.%N)
        "$@" --run_dir "$OUT/$name" > "$OUT/$name.log" 2>&1
        rc=$?
        prune "$OUT/$name"
        echo "[study] $name card=$card rc=$rc seconds=$(awk "BEGIN {print $(date +%s.%N) - $start}")"
        exit $rc
    ) &
    PIDS+=($!)
}

finish() {
    local fails=0
    for pid in "${PIDS[@]}"; do wait "$pid" || fails=$((fails + 1)); done
    PIDS=()
    return $fails
}

FAILS=0
declare -A EXTRA=(
    [seed2]="--solver pallas --seed 2"
    [seed3]="--solver pallas --seed 3"
    [bf16]="--solver pallas_packed --env_config {\"pallas_precision\":\"bf16_3x\"}"
    [dissipation]="--solver pallas --env_config {\"objective\":\"\"}"
    [latent]="--solver pallas --factory KSLatentConvolutionalLSTM
        --trainer {\"initial\":{\"min_steps\":250,\"max_steps\":2000},\"iterations\":{\"min_steps\":50,\"max_steps\":750}}
        --training {\"tau\":5,\"initial\":{\"tbtt\":10,\"patience\":10,\"batch_size\":64},\"iterations\":{\"tbtt\":10,\"patience\":10,\"batch_size\":64}}"
    [burgers]="--env_id BurgersEnv-v0 --reward_scale 500"
)
if [ "$MBPO_STEPS" -gt 0 ]; then
    for run in $RUNS; do
        # shellcheck disable=SC2086  # the flags split on spaces; no value has one
        launch mbpo_$run "${MBPO[@]}" ${EXTRA[$run]:?unknown run $run}
    done
    finish || FAILS=$((FAILS + $?))
fi
if [ "$SAC_STEPS" -gt 0 ]; then
    for seed in 0 1; do
        launch sac_l2control_seed$seed "${SAC[@]}" --seed $seed \
            --learning_starts 5000 --eval_freq 10000 --env_config '{"solver": "pallas"}'
        launch sac_dissipation_seed$seed "${SAC[@]}" --seed $seed \
            --env_config '{"objective": "", "solver": "pallas"}'
    done
    finish || FAILS=$((FAILS + $?))
fi
for log in "$OUT"/*.log; do
    echo "== $log"
    grep -E '^\[(rank|memory)\]' "$log" | tail -n 2
    tail -n 3 "$log"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
echo "[study] failed runs: $FAILS"
exit $FAILS
