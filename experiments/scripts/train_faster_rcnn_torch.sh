#!/bin/bash
# Train + test wrapper for the PyTorch port (frcnn_tpu_torch) on a CUDA card:
# the recipe of train_faster_rcnn.sh, through python -m frcnn_tpu_torch.tools.*.
# Usage: ./experiments/scripts/train_faster_rcnn_torch.sh DATASET NET [K V ...]
#   DATASET in {pascal_voc, pascal_voc_0712, coco}
#   NET in {vgg16, res50, res101, res152, mobile}
#   K V ...: extra config overrides, appended to --set
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
    STEPSIZE="[50000]"
    ITERS=70000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  pascal_voc_0712)
    TRAIN_IMDB="voc_2007_trainval+voc_2012_trainval"
    TEST_IMDB="voc_2007_test"
    STEPSIZE="[80000]"
    ITERS=110000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  coco)
    TRAIN_IMDB="coco_2014_train+coco_2014_valminusminival"
    TEST_IMDB="coco_2014_minival"
    STEPSIZE="[350000]"
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
LOG="experiments/logs/torch_${NET}_${TRAIN_IMDB}_${EXTRA_ARGS_SLUG}.txt.$(date +'%Y-%m-%d_%H-%M-%S')"
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

python -m frcnn_tpu_torch.tools.trainval_net \
  --imdb ${TRAIN_IMDB} \
  --imdbval ${TEST_IMDB} \
  --iters ${ITERS} \
  --cfg experiments/cfgs/${NET}.yml \
  --net ${NET} \
  --set ANCHOR_SCALES ${ANCHORS} ANCHOR_RATIOS ${RATIOS} \
        TRAIN.STEPSIZE ${STEPSIZE} ${EXTRA_ARGS}

./experiments/scripts/test_faster_rcnn_torch.sh $@
