/* The pair-major bundle adjustment's per-iteration problem on the host:
 * residuals, the analytic per-slot normal-equation blocks and their
 * assembly into JtJ / Jtb, for ``camera/ba_pairs.py``.
 *
 * The arithmetic is the torch chain's in ``camera/bundle_adjuster.py``
 * (``_rows_H_dH``, ``_project``, ``_pairs_ne_blocks``, ``assemble_scatter``,
 * ``_pairs_residuals``), operation for operation, in float64, one thread:
 *
 * - per camera: R by Rodrigues with the first-order branch below
 *   GEO_EPS_SQR, dR/dv_i by the exponential-coordinates formula (its limit
 *   [e_i]x below GEO_EPS_SQR), K, K^-1 and dK^-1/df (rotation.py,
 *   bundle_adjuster._intrinsics);
 * - per slot: H = K_f R_f R_t^T K_t^-1 and its 12 derivatives, in the
 *   order [f, ppx, ppy, v0, v1, v2] of the from camera, then of the to
 *   camera;
 * - per point: u = H (x, y, 1); the depth clamped to 1e-20 where
 *   |u_2| <= 1e-20, with a zero z-term there; the residual
 *   (from - u[:2] / z) w; the 2x12 Jacobian times w, each column times
 *   the caller's freeze mask (a product, so a NaN stays NaN).
 *
 * A slot's block Bp and vector bp sum its points in point order, the x row
 * before the y row; a point of weight 0 adds nothing.  JtJ and Jtb add the
 * blocks at the cameras' rows in slot order, as the CPU's accumulating
 * index_put_ does.  Nothing branches on a NaN or an inf: they flow into the
 * outputs as they would through the torch chain.  Every 3x3 product sums
 * its three terms left to right.  Build without -ffast-math: the rounding
 * is the point.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define GEO_EPS_SQR 1e-14
#define Z_EPS 1e-20

typedef struct {
    double K[9], Kinv[9], dKinv[9], R[9], dR[3][9], fi;
} cam_t;

static void mat3(const double *a, const double *b, double *c)
{
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            c[i * 3 + j] = a[i * 3] * b[j] + a[i * 3 + 1] * b[3 + j]
                           + a[i * 3 + 2] * b[6 + j];
}

static void transpose3(const double *a, double *t)
{
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            t[j * 3 + i] = a[i * 3 + j];
}

static void cross_matrix(double x, double y, double z, double *m)
{
    m[0] = 0.0; m[1] = -z;  m[2] = y;
    m[3] = z;   m[4] = 0.0; m[5] = -x;
    m[6] = -y;  m[7] = x;   m[8] = 0.0;
}

/* rotation.rodrigues and rotation.drodrigues for one camera */
static void rotation(const double *v, double *R, double dR[3][9])
{
    double theta2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
    int small = theta2 < GEO_EPS_SQR;
    double vx[9];
    cross_matrix(v[0], v[1], v[2], vx);
    if (small) {
        for (int k = 0; k < 9; k++)
            R[k] = (k % 4 == 0 ? 1.0 : 0.0) + vx[k];
    } else {
        double theta = sqrt(theta2);
        double u[3] = {v[0] / theta, v[1] / theta, v[2] / theta};
        double Ku[9];
        cross_matrix(u[0], u[1], u[2], Ku);
        double c = cos(theta), s = sin(theta);
        for (int i = 0; i < 3; i++)
            for (int j = 0; j < 3; j++)
                R[i * 3 + j] = c * (i == j ? 1.0 : 0.0)
                               + (1 - c) * (u[i] * u[j]) + s * Ku[i * 3 + j];
    }
    for (int i = 0; i < 3; i++) {
        if (small) {
            /* the limit [e_i]x */
            cross_matrix(i == 0, i == 1, i == 2, dR[i]);
            continue;
        }
        /* w = v x (I - R) e_i; (v_i [v]x + [w]x) / |v|^2 . R */
        double col[3], w[3], wx[9], num[9];
        for (int r = 0; r < 3; r++)
            col[r] = (r == i ? 1.0 : 0.0) - R[r * 3 + i];
        w[0] = v[1] * col[2] - v[2] * col[1];
        w[1] = v[2] * col[0] - v[0] * col[2];
        w[2] = v[0] * col[1] - v[1] * col[0];
        cross_matrix(w[0], w[1], w[2], wx);
        for (int k = 0; k < 9; k++)
            num[k] = (v[i] * vx[k] + wx[k]) / theta2;
        mat3(num, R, dR[i]);
    }
}

static void camera_terms(const double *params, int64_t n_cam, cam_t *cams)
{
    for (int64_t c = 0; c < n_cam; c++) {
        const double *p = params + 6 * c;
        cam_t *o = cams + c;
        double f = p[0], px = p[1], py = p[2];
        double fi = 1.0 / f, fi2 = fi * fi;
        double K[9] = {f, 0.0, px, 0.0, f, py, 0.0, 0.0, 1.0};
        double Kinv[9] = {fi, 0.0, -px * fi, 0.0, fi, -py * fi,
                          0.0, 0.0, 1.0};
        double dKinv[9] = {-fi2, 0.0, px * fi2, 0.0, -fi2, py * fi2,
                           0.0, 0.0, 0.0};
        memcpy(o->K, K, sizeof K);
        memcpy(o->Kinv, Kinv, sizeof Kinv);
        memcpy(o->dKinv, dKinv, sizeof dKinv);
        o->fi = fi;
        rotation(p + 3, o->R, o->dR);
    }
}

static int rows_ok(const int64_t *F, const int64_t *T, int64_t P,
                   int64_t n_cam)
{
    for (int64_t p = 0; p < P; p++)
        if (F[p] < 0 || F[p] >= n_cam || T[p] < 0 || T[p] >= n_cam)
            return 0;
    return 1;
}

/* H of one slot and the pieces its derivatives reuse: A = K_f R_f,
 * Bq = R_t^T K_t^-1 */
static void slot_H(const cam_t *cf, const cam_t *ct, double *A, double *Bq,
                   double *RtT, double *H)
{
    transpose3(ct->R, RtT);
    mat3(cf->K, cf->R, A);
    mat3(RtT, ct->Kinv, Bq);
    mat3(A, Bq, H);
}

/* dH/dtheta [12][9] of one slot (bundle_adjuster._rows_H_dH) */
static void slot_dH(const cam_t *cf, const cam_t *ct, const double *A,
                    const double *Bq, const double *RtT, double dH[12][9])
{
    static const double e3[3] = {0.0, 0.0, 1.0};
    double RB[9], ARt[9], t[9], dRt[9];
    mat3(cf->R, Bq, RB);
    for (int k = 0; k < 9; k++) {
        dH[0][k] = k < 6 ? RB[k] : 0.0;
        dH[1][k] = k < 3 ? RB[6 + k] : 0.0;
        dH[2][k] = k >= 3 && k < 6 ? RB[3 + k] : 0.0;
    }
    for (int i = 0; i < 3; i++) {
        mat3(cf->K, cf->dR[i], t);
        mat3(t, Bq, dH[3 + i]);
    }
    mat3(A, RtT, ARt);
    mat3(ARt, ct->dKinv, dH[6]);
    for (int r = 0; r < 3; r++)
        for (int m = 0; m < 3; m++) {
            dH[7][r * 3 + m] = -(ARt[r * 3] * ct->fi * e3[m]);
            dH[8][r * 3 + m] = -(ARt[r * 3 + 1] * ct->fi * e3[m]);
        }
    for (int i = 0; i < 3; i++) {
        transpose3(ct->dR[i], dRt);
        mat3(A, dRt, t);
        mat3(t, ct->Kinv, dH[9 + i]);
    }
}

/* u = H (x, y, 1), the clamped depth and the z-term mask */
static void project(const double *H, double x, double y, double *u,
                    double *zs, int *zok)
{
    for (int i = 0; i < 3; i++)
        u[i] = H[i * 3] * x + H[i * 3 + 1] * y + H[i * 3 + 2];
    *zok = fabs(u[2]) > Z_EPS;
    *zs = *zok ? u[2] : Z_EPS;
}

/* Weighted residuals resid [P, M, 2] of the slots with the swap resolved:
 * pt_to, pt_from [P, M, 2], the point weights times the slot weights wm
 * [P, M], the from and to cameras F, T [P].  Returns 0, or -1 for a camera
 * index out of range, -2 when out of memory. */
int ba_pairs_residuals(const double *params, int64_t n_cam,
                       const double *pt_to, const double *pt_from,
                       const double *wm, const int64_t *F, const int64_t *T,
                       int64_t P, int64_t M, double *resid)
{
    if (!rows_ok(F, T, P, n_cam))
        return -1;
    cam_t *cams = malloc(sizeof(cam_t) * (size_t)(n_cam > 0 ? n_cam : 1));
    if (cams == NULL)
        return -2;
    camera_terms(params, n_cam, cams);
    for (int64_t p = 0; p < P; p++) {
        double A[9], Bq[9], RtT[9], H[9];
        slot_H(cams + F[p], cams + T[p], A, Bq, RtT, H);
        for (int64_t m = 0; m < M; m++) {
            const int64_t t = p * M + m;
            double u[3], zs;
            int zok;
            project(H, pt_to[2 * t], pt_to[2 * t + 1], u, &zs, &zok);
            resid[2 * t] = (pt_from[2 * t] - u[0] / zs) * wm[t];
            resid[2 * t + 1] = (pt_from[2 * t + 1] - u[1] / zs) * wm[t];
        }
    }
    free(cams);
    return 0;
}

/* The normal equations of the same slots at the residuals ``resid`` [P, M,
 * 2], with the Jacobian's columns times ``upd`` [n_cam, 6] (0 freezes a
 * parameter).  Writes, where the pointer is not NULL: the blocks Bp [P, 12,
 * 12] and bp [P, 12] (rows [from(6) | to(6)]), and JtJ [6n, 6n] and Jtb
 * [6n] (set, not added to).  Returns as ba_pairs_residuals. */
int ba_pairs_normal_equations(const double *params, int64_t n_cam,
                              const double *pt_to, const double *wm,
                              const int64_t *F, const int64_t *T, int64_t P,
                              int64_t M, const double *resid,
                              const double *upd, double *Bp, double *bp,
                              double *JtJ, double *Jtb)
{
    if (!rows_ok(F, T, P, n_cam))
        return -1;
    cam_t *cams = malloc(sizeof(cam_t) * (size_t)(n_cam > 0 ? n_cam : 1));
    if (cams == NULL)
        return -2;
    camera_terms(params, n_cam, cams);
    const int64_t n6 = 6 * n_cam;
    if (JtJ != NULL) {
        memset(JtJ, 0, sizeof(double) * (size_t)(n6 * n6));
        memset(Jtb, 0, sizeof(double) * (size_t)n6);
    }
    for (int64_t p = 0; p < P; p++) {
        double B[12][12], b[12];
        memset(B, 0, sizeof B);
        memset(b, 0, sizeof b);
        const int64_t f = F[p], to = T[p];
        int64_t m0 = 0;
        while (m0 < M && wm[p * M + m0] == 0.0)
            m0++;
        if (m0 < M) {
            double A[9], Bq[9], RtT[9], H[9], dH[12][9], mask[12];
            slot_H(cams + f, cams + to, A, Bq, RtT, H);
            slot_dH(cams + f, cams + to, A, Bq, RtT, dH);
            for (int k = 0; k < 6; k++) {
                mask[k] = upd[6 * f + k];
                mask[6 + k] = upd[6 * to + k];
            }
            for (int64_t m = m0; m < M; m++) {
                const int64_t t = p * M + m;
                const double w = wm[t];
                if (w == 0.0)
                    continue;
                const double x = pt_to[2 * t], y = pt_to[2 * t + 1];
                double u[3], zs, Jx[12], Jy[12];
                int zok;
                project(H, x, y, u, &zs, &zok);
                const double zi = 1.0 / zs;
                const double zterm = zok ? zi * zi : 0.0;
                const double ux = u[0] * zterm, uy = u[1] * zterm;
                for (int k = 0; k < 12; k++) {
                    const double *d = dH[k];
                    double du0 = d[0] * x + d[1] * y + d[2];
                    double du1 = d[3] * x + d[4] * y + d[5];
                    double du2 = d[6] * x + d[7] * y + d[8];
                    Jx[k] = -(du0 * zi - du2 * ux) * w * mask[k];
                    Jy[k] = -(du1 * zi - du2 * uy) * w * mask[k];
                }
                const double rx = resid[2 * t], ry = resid[2 * t + 1];
                for (int i = 0; i < 12; i++) {
                    for (int j = i; j < 12; j++) {
                        B[i][j] += Jx[i] * Jx[j];
                        B[i][j] += Jy[i] * Jy[j];
                    }
                    b[i] += Jx[i] * rx;
                    b[i] += Jy[i] * ry;
                }
            }
            for (int i = 0; i < 12; i++)
                for (int j = 0; j < i; j++)
                    B[i][j] = B[j][i];
        }
        if (Bp != NULL) {
            memcpy(Bp + 144 * p, B, sizeof B);
            memcpy(bp + 12 * p, b, sizeof b);
        }
        if (JtJ != NULL) {
            int64_t rows[12];
            for (int k = 0; k < 6; k++) {
                rows[k] = 6 * f + k;
                rows[6 + k] = 6 * to + k;
            }
            for (int i = 0; i < 12; i++) {
                double *row = JtJ + rows[i] * n6;
                for (int j = 0; j < 12; j++)
                    row[rows[j]] += B[i][j];
                Jtb[rows[i]] += b[i];
            }
        }
    }
    free(cams);
    return 0;
}
