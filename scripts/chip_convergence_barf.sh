#!/usr/bin/env bash
# The port's BARF convergence run on one GPU, at the protocol of the JAX
# run in docs/evidence/synthetic/barf_convergence_20k_r5_cpu64
# (its options.json): configs/barf_synthetic_convergence_20k.yaml on the
# solids scene, 100 views at 64x64, 512 rays x 64 samples, se(3) noise
# 0.15, c2f [0.1, 0.5], 20k iterations (the JAX run stopped at 10k), the
# pose errors every 1000 iterations (freq.scalar 250); then the evaluate
# CLI (test-time photometric optimisation, 100 steps a view at
# optim.lr_pose, on the scene's 4 test views) on the final checkpoint and
# on the iteration-10000 snapshot, where the JAX run was evaluated.
#
#     [OUT=dir] bash scripts/chip_convergence_barf.sh [extra --key=value overrides]
#
# Writes into $OUT (default output/convergence_barf_card): gpu.txt (name,
# power limit), smi.csv (clocks, power, temperature, utilization every
# 30 s), train.log, eval.log, eval_it10000.log, and the run's log.jsonl,
# quant.json, quant_pose.txt and quant_eval.json (the final checkpoint's)
# and quant_eval_it10000.json.
set -u
out=${OUT:-output/convergence_barf_card}
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
args=(--yaml=configs/barf_synthetic_convergence_20k.yaml
      "--data.image_size=[64,64]" --nerf.n_rays=512 --nerf.sample_intvs=64
      --+tb_logging=false "$@")
run=output/synthetic/barf_convergence_20k
t0=$(date +%s)
python -m joint_tensorf_tpu_torch.train "${args[@]}" > "$out/train.log" 2>&1
rc=$?
echo "wall_s $(( $(date +%s) - t0 ))" | tee -a "$out/train.log"
if [ $rc -eq 0 ]; then
  t0=$(date +%s)
  python -m joint_tensorf_tpu_torch.evaluate "${args[@]}" \
    --generate_video=false --generate_pose_video=false > "$out/eval.log" 2>&1
  rc=$?
  echo "wall_s $(( $(date +%s) - t0 ))" | tee -a "$out/eval.log"
  tail -5 "$out/eval.log"
  cp "$run/quant_pose.txt" "$run/quant_eval.json" "$out/" 2>/dev/null
  if python -m joint_tensorf_tpu_torch.evaluate "${args[@]}" \
      --ckpt="$run/model_it10000.ckpt.npz" --generate_video=false \
      --generate_pose_video=false > "$out/eval_it10000.log" 2>&1; then
    cp "$run/quant_eval.json" "$out/quant_eval_it10000.json"
  else
    rc=1
  fi
  tail -2 "$out/eval_it10000.log"
fi
cp "$run/log.jsonl" "$run/quant.json" "$out/" 2>/dev/null
tail -12 "$out/train.log"
exit $rc
