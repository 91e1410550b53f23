#!/usr/bin/env bash
# The port's planar convergence run on one GPU: configs/planar_bat.yaml as
# it stands (the reference's options/planar_bat.yaml: 500^2 SVD image,
# rank 100, 256-tap Gaussian blur on the kernel_t schedule 128 -> 0,
# 5 patches of 180^2 under SL(3) perturbations, 15k iterations), the run
# docs/CONVERGENCE.md reports for the JAX package.
#
#     [OUT=dir] bash scripts/chip_convergence_planar.sh [extra --key=value overrides]
#
# Writes into $OUT (default output/convergence_planar_card): gpu.txt,
# smi.csv, train.log, and the run's log.jsonl and quant.json (psnr and
# warp_error every freq.scalar iterations).
set -u
out=${OUT:-output/convergence_planar_card}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
( while true; do
    nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu,utilization.gpu \
      --format=csv,noheader >> "$out/smi.csv"
    sleep 30
  done ) &
smi=$!
trap 'kill $smi 2>/dev/null' EXIT
t0=$(date +%s)
python -m joint_tensorf_tpu_torch.planar --yaml=configs/planar_bat.yaml "$@" \
  > "$out/train.log" 2>&1
rc=$?
echo "wall_s $(( $(date +%s) - t0 ))" | tee -a "$out/train.log"
cp output/default/planar_gaussian_bat/log.jsonl \
   output/default/planar_gaussian_bat/quant.json "$out/" 2>/dev/null
tail -6 "$out/train.log"
exit $rc
