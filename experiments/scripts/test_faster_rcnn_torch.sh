#!/bin/bash
# Test wrapper for the PyTorch port (frcnn_tpu_torch) on a CUDA card: the
# recipe of test_faster_rcnn.sh, on the .pth snapshot that
# train_faster_rcnn_torch.sh writes.
# Usage: ./experiments/scripts/test_faster_rcnn_torch.sh DATASET NET [K V ...]
set -x
set -e

export PYTHONUNBUFFERED="True"

DATASET=$1
NET=$2
array=( $@ )
len=${#array[@]}
EXTRA_ARGS=${array[@]:2:$len}
EXTRA_ARGS_SLUG=${EXTRA_ARGS// /_}

case ${DATASET} in
  pascal_voc)
    TRAIN_IMDB="voc_2007_trainval"
    TEST_IMDB="voc_2007_test"
    ITERS=70000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  pascal_voc_0712)
    TRAIN_IMDB="voc_2007_trainval+voc_2012_trainval"
    TEST_IMDB="voc_2007_test"
    ITERS=110000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  coco)
    TRAIN_IMDB="coco_2014_train+coco_2014_valminusminival"
    TEST_IMDB="coco_2014_minival"
    ITERS=490000
    ANCHORS="[4,8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  *)
    echo "No dataset given"
    exit 1
    ;;
esac

mkdir -p experiments/logs
LOG="experiments/logs/test_torch_${NET}_${TRAIN_IMDB}_${EXTRA_ARGS_SLUG}.txt.$(date +'%Y-%m-%d_%H-%M-%S')"
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

MODEL="output/${NET}/${TRAIN_IMDB}/default/${NET}_faster_rcnn_iter_${ITERS}.pth"

python -m frcnn_tpu_torch.tools.test_net \
  --imdb ${TEST_IMDB} \
  --model ${MODEL} \
  --cfg experiments/cfgs/${NET}.yml \
  --net ${NET} \
  --set ANCHOR_SCALES ${ANCHORS} ANCHOR_RATIOS ${RATIOS} ${EXTRA_ARGS}
