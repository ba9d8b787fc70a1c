/* Minimal single-rank MPI + MPI-IO shim.
 *
 * Just enough surface for the reference's src/matrixBinfile.c to compile
 * and run serially (this image has no MPI), so its ACTUAL .bmx write/read
 * code — not a re-implementation — cross-validates sparsebench's
 * byte-compatible host/binfile.py (tests/test_reference_parity.py).
 *
 * Semantics implemented (the subset matrixBinfile.c exercises):
 *   - MPI_File views: set_view(disp, etype) re-bases the file at byte
 *     offset `disp` with element size `etype`; positions/seeks are in
 *     etype units relative to the view (MPI-3.1 13.3).
 *   - MPI_Datatype is its byte size; Type_create_struct computes the
 *     struct span (exact for FEntry {u32,f32} = 8, no tail padding).
 *   - Collectives degrade to single-rank copies/no-ops.
 */
#ifndef SB_SERIAL_MPI_SHIM_H
#define SB_SERIAL_MPI_SHIM_H

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef long long MPI_Offset;
typedef long long MPI_Aint;
typedef int MPI_Comm;
typedef int MPI_Info;
typedef int MPI_Datatype; /* value = element size in bytes */
typedef struct {
  long long bytes;
} MPI_Status;

#define MPI_COMM_WORLD 0
#define MPI_INFO_NULL 0
#define MPI_STATUS_IGNORE ((MPI_Status*)0)
#define MPI_CHAR 1
#define MPI_INT 4
#define MPI_UNSIGNED 4
#define MPI_FLOAT 4
#define MPI_MODE_RDONLY 1
#define MPI_MODE_WRONLY 2
#define MPI_MODE_CREATE 4
#define MPI_SEEK_SET 100
#define MPI_SEEK_CUR 101

typedef struct {
  FILE* fp;
  MPI_Offset view_disp; /* bytes */
  int etype;            /* bytes per element of the current view */
} MPI_File_s;
typedef MPI_File_s* MPI_File;

static inline int MPI_File_open(
    MPI_Comm comm, char* filename, int amode, MPI_Info info, MPI_File* fh)
{
  (void)comm;
  (void)info;
  MPI_File f = (MPI_File)malloc(sizeof(MPI_File_s));
  f->fp = fopen(filename, (amode & MPI_MODE_RDONLY) ? "rb" : "wb");
  if (!f->fp) {
    free(f);
    return 1;
  }
  f->view_disp = 0;
  f->etype     = 1;
  *fh          = f;
  return 0;
}

static inline int MPI_File_close(MPI_File* fh)
{
  fclose((*fh)->fp);
  free(*fh);
  *fh = NULL;
  return 0;
}

static inline int MPI_File_set_view(MPI_File fh, MPI_Offset disp,
    MPI_Datatype etype, MPI_Datatype filetype, const char* datarep,
    MPI_Info info)
{
  (void)filetype;
  (void)datarep;
  (void)info;
  fh->view_disp = disp;
  fh->etype     = etype;
  fseek(fh->fp, (long)disp, SEEK_SET);
  return 0;
}

static inline int MPI_File_write(
    MPI_File fh, const void* buf, int count, MPI_Datatype dt, MPI_Status* st)
{
  size_t n = fwrite(buf, (size_t)dt, (size_t)count, fh->fp);
  if (st) st->bytes = (long long)n * dt;
  return n == (size_t)count ? 0 : 1;
}

static inline int MPI_File_read(
    MPI_File fh, void* buf, int count, MPI_Datatype dt, MPI_Status* st)
{
  size_t n = fread(buf, (size_t)dt, (size_t)count, fh->fp);
  if (st) st->bytes = (long long)n * dt;
  return 0;
}

static inline int MPI_File_sync(MPI_File fh)
{
  fflush(fh->fp);
  return 0;
}

static inline int MPI_File_get_size(MPI_File fh, MPI_Offset* size)
{
  fflush(fh->fp);
  long cur = ftell(fh->fp);
  fseek(fh->fp, 0L, SEEK_END);
  *size = (MPI_Offset)ftell(fh->fp);
  fseek(fh->fp, cur, SEEK_SET);
  return 0;
}

static inline int MPI_File_get_position(MPI_File fh, MPI_Offset* offset)
{
  *offset = ((MPI_Offset)ftell(fh->fp) - fh->view_disp) / fh->etype;
  return 0;
}

static inline int MPI_File_get_byte_offset(
    MPI_File fh, MPI_Offset offset, MPI_Offset* disp)
{
  *disp = fh->view_disp + offset * fh->etype;
  return 0;
}

static inline int MPI_File_seek(MPI_File fh, MPI_Offset offset, int whence)
{
  if (whence == MPI_SEEK_SET) {
    fseek(fh->fp, (long)(fh->view_disp + offset * fh->etype), SEEK_SET);
  } else {
    fseek(fh->fp, (long)(offset * fh->etype), SEEK_CUR);
  }
  return 0;
}

static inline int MPI_Get_count(
    const MPI_Status* st, MPI_Datatype dt, int* count)
{
  *count = (int)(st->bytes / dt);
  return 0;
}

static inline int MPI_Barrier(MPI_Comm c)
{
  (void)c;
  return 0;
}

static inline int MPI_Allgather(const void* sbuf, int scount,
    MPI_Datatype sdt, void* rbuf, int rcount, MPI_Datatype rdt, MPI_Comm comm)
{
  (void)rcount;
  (void)rdt;
  (void)comm;
  memcpy(rbuf, sbuf, (size_t)scount * sdt);
  return 0;
}

static inline int MPI_Get_address(const void* location, MPI_Aint* address)
{
  *address = (MPI_Aint)location;
  return 0;
}

static inline MPI_Aint MPI_Aint_diff(MPI_Aint a, MPI_Aint b) { return a - b; }

static inline int MPI_Type_create_struct(int count, const int* lengths,
    const MPI_Aint* displs, const MPI_Datatype* types, MPI_Datatype* newtype)
{
  MPI_Aint end = 0;
  for (int i = 0; i < count; i++) {
    MPI_Aint e = displs[i] + (MPI_Aint)lengths[i] * types[i];
    if (e > end) end = e;
  }
  *newtype = (MPI_Datatype)end;
  return 0;
}

static inline int MPI_Type_commit(MPI_Datatype* t)
{
  (void)t;
  return 0;
}

static inline int MPI_Type_free(MPI_Datatype* t)
{
  (void)t;
  return 0;
}

#endif /* SB_SERIAL_MPI_SHIM_H */
