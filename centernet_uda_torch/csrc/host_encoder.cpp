// Host-side CenterNet target encoder, image normalisation and COCO greedy
// matcher of the PyTorch port, in the port's layouts.
//
// The data loader runs its samples on threads, and the per-object Python
// loop of the target encoder, the float passes of the normalisation and the
// evaluator's triple loop over thresholds x detections x ground truths hold
// the interpreter lock between the large numpy calls. Here the same work is
// plain C++ behind a C interface, loaded with ctypes (a CDLL call releases
// the lock), built with g++ at first use by ``native/__init__.py``. This is
// the port's counterpart of ``centernet_uda_tpu/native/encoder.cpp``; it
// writes the port's layouts directly: the heatmap (C, H, W) and the
// normalised image (3, H, W).
//
// Every function computes what its plain version computes, in the same
// arithmetic: ``ops/gaussian.py`` (``gaussian_radius`` on doubles,
// ``draw_gaussian``, ``encode_targets``), ``data/coco.py``
// (``normalize_image``) and ``evaluation/coco_eval_np.py``
// (``greedy_match``). Floating-point contraction is off in the build, so
// float32 expressions round as numpy rounds them.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

extern "C" {

// CornerNet's three-case minimum-overlap gaussian radius.
double cn_gaussian_radius(double height, double width, double min_overlap) {
    const double a1 = 1.0;
    const double b1 = height + width;
    const double c1 = width * height * (1 - min_overlap) / (1 + min_overlap);
    const double sq1 = std::sqrt(std::max(b1 * b1 - 4 * a1 * c1, 0.0));
    const double r1 = (b1 + sq1) / 2.0;

    const double a2 = 4.0;
    const double b2 = 2.0 * (height + width);
    const double c2 = (1 - min_overlap) * width * height;
    const double sq2 = std::sqrt(std::max(b2 * b2 - 4 * a2 * c2, 0.0));
    const double r2 = (b2 + sq2) / 2.0;

    const double a3 = 4.0 * min_overlap;
    const double b3 = -2.0 * min_overlap * (height + width);
    const double c3 = (min_overlap - 1) * width * height;
    const double sq3 = std::sqrt(std::max(b3 * b3 - 4 * a3 * c3, 0.0));
    const double r3 = (b3 + sq3) / 2.0;
    return std::min(r1, std::min(r2, r3));
}

// Max-composite a truncated gaussian (diameter 2r+1, sigma diameter/6,
// values below DBL_EPSILON of its peak of 1 set to 0) centred on the
// integer pixel (cx, cy) into the row-major (height, width) plane, clipped
// at the border.
void cn_draw_gaussian(float* plane, int height, int width, int cx, int cy,
                      int radius) {
    const int diameter = 2 * radius + 1;
    const double sigma = diameter / 6.0;
    const double denom = 2 * sigma * sigma;
    const int left = std::min(cx, radius);
    const int right = std::min(width - cx, radius + 1);
    const int top = std::min(cy, radius);
    const int bottom = std::min(height - cy, radius + 1);
    if (left + right <= 0 || top + bottom <= 0) return;
    for (int dy = -top; dy < bottom; ++dy) {
        float* row = plane + (std::ptrdiff_t)(cy + dy) * width + cx;
        for (int dx = -left; dx < right; ++dx) {
            double g = std::exp(-((double)dx * dx + (double)dy * dy) / denom);
            if (g < DBL_EPSILON) g = 0.0;
            const float v = (float)g;
            if (v > row[dx]) row[dx] = v;
        }
    }
}

// CenterNet targets of one image's axis-aligned boxes.
//
// boxes (n, 4) x1, y1, x2, y2 in output-map pixels; classes (n,), each a
// plane of hm (checked by the caller); areas (n,) the annotation's area,
// NaN where it has none (then the clipped box's w * h). Only the first
// max_dets objects count.
// Outputs, zeroed by the caller: hm (classes, out_h, out_w); wh, reg
// (max_dets, 2); ind (max_dets,) y * out_w + x; reg_mask (max_dets,);
// gt_dets (max_dets, 6) x1, y1, x2, y2, 1, class; gt_areas (max_dets,).
void cn_encode_targets(const float* boxes, const int32_t* classes,
                       const float* areas, int num_objs, int out_h, int out_w,
                       int max_dets, double min_overlap, float* hm, float* wh,
                       float* reg, int64_t* ind, uint8_t* reg_mask,
                       float* gt_dets, float* gt_areas) {
    const int n = std::min(num_objs, max_dets);
    const float max_x = (float)(out_w - 1), max_y = (float)(out_h - 1);
    for (int k = 0; k < n; ++k) {
        const float x1 = std::min(std::max(boxes[4 * k + 0], 0.f), max_x);
        const float y1 = std::min(std::max(boxes[4 * k + 1], 0.f), max_y);
        const float x2 = std::min(std::max(boxes[4 * k + 2], 0.f), max_x);
        const float y2 = std::min(std::max(boxes[4 * k + 3], 0.f), max_y);
        const float h = y2 - y1, w = x2 - x1;
        if (h <= 0.f || w <= 0.f) continue;
        const int radius = std::max(
            0, (int)cn_gaussian_radius(std::ceil(h), std::ceil(w),
                                       min_overlap));
        const float ctx = (x1 + x2) / 2.f, cty = (y1 + y2) / 2.f;
        const int cxi = (int)ctx, cyi = (int)cty;
        const int cls = classes[k];
        cn_draw_gaussian(hm + (std::ptrdiff_t)cls * out_h * out_w, out_h,
                         out_w, cxi, cyi, radius);
        wh[2 * k + 0] = w;
        wh[2 * k + 1] = h;
        ind[k] = (int64_t)cyi * out_w + cxi;
        reg[2 * k + 0] = ctx - (float)cxi;
        reg[2 * k + 1] = cty - (float)cyi;
        reg_mask[k] = 1;
        gt_dets[6 * k + 0] = ctx - w / 2.f;
        gt_dets[6 * k + 1] = cty - h / 2.f;
        gt_dets[6 * k + 2] = ctx + w / 2.f;
        gt_dets[6 * k + 3] = cty + h / 2.f;
        gt_dets[6 * k + 4] = 1.f;
        gt_dets[6 * k + 5] = (float)cls;
        gt_areas[k] = std::isnan(areas[k]) ? w * h : areas[k];
    }
}

// (x / 255 - mean) / std of a (height, width, 3) uint8 image, written as a
// (3, height, width) float32 image: one pass, through a 256-entry table per
// channel that holds the float32 result of each byte value.
void cn_normalize_image(const uint8_t* src, float* dst, int height, int width,
                        const float* mean, const float* stdv) {
    float table[3][256];
    for (int c = 0; c < 3; ++c) {
        for (int v = 0; v < 256; ++v) {
            table[c][v] = ((float)v / 255.f - mean[c]) / stdv[c];
        }
    }
    const std::ptrdiff_t plane = (std::ptrdiff_t)height * width;
    float* d0 = dst;
    float* d1 = dst + plane;
    float* d2 = dst + 2 * plane;
    for (std::ptrdiff_t i = 0; i < plane; ++i) {
        const uint8_t* p = src + 3 * i;
        d0[i] = table[0][p[0]];
        d1[i] = table[1][p[1]];
        d2[i] = table[2][p[2]];
    }
}

// COCO's greedy matching of one (image, category) cell at every IoU
// threshold (pycocotools' evaluateImg): detections in score order, each
// takes the best still-free ground truth at or above the threshold (a
// crowd stays free), and stops at the ignored ground truths once it holds
// a non-ignored one.
//
// ious (num_dt, num_gt) row-major; gt_ignore, gt_crowd (num_gt,) 0/1, the
// ignored ones last; thrs (num_thrs,); dt_out_of_range (num_dt,) 0/1.
// Outputs (num_thrs, num_dt): dtm 1 where matched; dt_ignore the matched
// ground truth's ignore flag, or dt_out_of_range where unmatched.
// gt_taken (num_gt,) is scratch.
void cn_coco_greedy_match(const double* ious, int num_dt, int num_gt,
                          const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                          const double* thrs, int num_thrs,
                          const uint8_t* dt_out_of_range, uint8_t* dtm,
                          uint8_t* dt_ignore, uint8_t* gt_taken) {
    for (int t = 0; t < num_thrs; ++t) {
        for (int g = 0; g < num_gt; ++g) gt_taken[g] = 0;
        for (int d = 0; d < num_dt; ++d) {
            double best = std::min(thrs[t], 1 - 1e-10);
            int match = -1;
            const double* row = ious + (std::ptrdiff_t)d * num_gt;
            for (int g = 0; g < num_gt; ++g) {
                if (gt_taken[g] && !gt_crowd[g]) continue;
                if (match > -1 && !gt_ignore[match] && gt_ignore[g]) break;
                if (row[g] < best) continue;
                best = row[g];
                match = g;
            }
            const std::ptrdiff_t i = (std::ptrdiff_t)t * num_dt + d;
            if (match == -1) {
                dtm[i] = 0;
                dt_ignore[i] = dt_out_of_range[d];
            } else {
                dtm[i] = 1;
                dt_ignore[i] = gt_ignore[match];
                gt_taken[match] = 1;
            }
        }
    }
}

}  // extern "C"
