#!/usr/bin/env bash
# The port's convergence run on one GPU: BAT on the solids scene at the
# published widths of configs/bat_synthetic_convergence_20k.yaml (128^2,
# 100 views, 48^3 -> 160^3, se(3) noise 0.15), 20k iterations, with the
# validation cadence of the JAX run in
# docs/evidence/synthetic/convergence_20k_r5_default (freq.val 1000).
#
#     [OUT=dir] bash scripts/chip_convergence.sh [extra --key=value overrides]
#
# Writes into $OUT (default output/convergence_card): gpu.txt (name, power
# limit), smi.csv (clocks, power, temperature, utilization every 30 s),
# train.log, and the run's log.jsonl and quant.json (rot_deg / trans /
# val_psnr rows).
set -u
out=${OUT:-output/convergence_card}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
( while true; do
    nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu,utilization.gpu \
      --format=csv,noheader >> "$out/smi.csv"
    sleep 30
  done ) &
smi=$!
trap 'kill $smi 2>/dev/null' EXIT
t0=$(date +%s)
python -m joint_tensorf_tpu_torch.train \
  --yaml=configs/bat_synthetic_convergence_20k.yaml --freq.val=1000 \
  --+tb_logging=false "$@" > "$out/train.log" 2>&1
rc=$?
echo "wall_s $(( $(date +%s) - t0 ))" | tee -a "$out/train.log"
cp output/synthetic/convergence_20k/log.jsonl \
   output/synthetic/convergence_20k/quant.json "$out/" 2>/dev/null
tail -30 "$out/train.log"
exit $rc
