// Native host-side batch packer for pl_bert_tpu_torch: a copy of
// pl_bert_tpu/runtime/native/packer.cc, built with the host compiler by
// pl_bert_tpu_torch/runtime/build.py::build_host (no CUDA, no torch).
//
// The per-batch host work — mapping phoneme words (Python unicode) to
// symbol ids, inserting separators, tracking word ids and cropping to the
// static sequence length — is the framework's host hot loop (the
// reference does this per sample in Python, reference: dataloader.py:59-142
// and char_indexer.py:19-25). This extension performs the whole batch in
// one C pass over the UTF-32 representations with a dense codepoint→id
// lookup table, writing directly into preallocated int32 buffers.
//
// Built as a plain CPython extension (no pybind11, no numpy C API): the
// Python wrapper hands in writable buffers via the buffer protocol.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

namespace {

std::vector<int32_t> g_lookup;  // codepoint → symbol id
int32_t g_unknown_id = 187;
int32_t g_separator_id = 186;

// set_symbol_table(lookup_bytes: bytes, unknown_id: int, separator_id: int)
PyObject* SetSymbolTable(PyObject*, PyObject* args) {
  Py_buffer view;
  int unknown_id, separator_id;
  if (!PyArg_ParseTuple(args, "y*ii", &view, &unknown_id, &separator_id)) {
    return nullptr;
  }
  const auto* data = static_cast<const int32_t*>(view.buf);
  g_lookup.assign(data, data + view.len / sizeof(int32_t));
  g_unknown_id = unknown_id;
  g_separator_id = separator_id;
  PyBuffer_Release(&view);
  Py_RETURN_NONE;
}

inline int32_t LookupId(Py_UCS4 cp) {
  if (cp < g_lookup.size()) return g_lookup[cp];
  return g_unknown_id;
}

// pack_batch(batch: list[list[str]], max_len: int,
//            label_out: writable buffer int32 [B*max_len],
//            word_out: writable buffer int32 [B*max_len],
//            len_out: writable buffer int32 [B],
//            offsets: readable buffer int32 [B]) -> None
//
// label/word buffers must be pre-filled by the caller (zeros / -1).
// offsets[i] skips that many leading chars (separators included) of
// sample i's concatenated stream — the random-crop window start; word
// ids are re-based to the first word visible in the window.
PyObject* PackBatch(PyObject*, PyObject* args) {
  PyObject* batch;
  Py_ssize_t max_len;
  Py_buffer label_buf, word_buf, len_buf, off_buf;
  if (!PyArg_ParseTuple(args, "Onw*w*w*y*", &batch, &max_len, &label_buf,
                        &word_buf, &len_buf, &off_buf)) {
    return nullptr;
  }
  auto release = [&]() {
    PyBuffer_Release(&label_buf);
    PyBuffer_Release(&word_buf);
    PyBuffer_Release(&len_buf);
    PyBuffer_Release(&off_buf);
  };
  if (g_lookup.empty()) {
    release();
    PyErr_SetString(PyExc_RuntimeError, "symbol table not initialised");
    return nullptr;
  }
  if (!PyList_Check(batch)) {
    release();
    PyErr_SetString(PyExc_TypeError, "batch must be a list of samples");
    return nullptr;
  }
  const Py_ssize_t b = PyList_GET_SIZE(batch);
  if (label_buf.len < static_cast<Py_ssize_t>(b * max_len * sizeof(int32_t)) ||
      word_buf.len < static_cast<Py_ssize_t>(b * max_len * sizeof(int32_t)) ||
      len_buf.len < static_cast<Py_ssize_t>(b * sizeof(int32_t)) ||
      off_buf.len < static_cast<Py_ssize_t>(b * sizeof(int32_t))) {
    release();
    PyErr_SetString(PyExc_ValueError, "output buffers too small");
    return nullptr;
  }
  auto* labels = static_cast<int32_t*>(label_buf.buf);
  auto* words = static_cast<int32_t*>(word_buf.buf);
  auto* lens = static_cast<int32_t*>(len_buf.buf);
  const auto* offsets = static_cast<const int32_t*>(off_buf.buf);

  for (Py_ssize_t i = 0; i < b; ++i) {
    PyObject* sample = PyList_GET_ITEM(batch, i);
    if (!PySequence_Check(sample)) {
      release();
      PyErr_SetString(PyExc_TypeError, "sample must be a sequence of words");
      return nullptr;
    }
    int32_t* label_row = labels + i * max_len;
    int32_t* word_row = words + i * max_len;
    Py_ssize_t pos = 0;
    Py_ssize_t stream = 0;  // position in the uncropped char stream
    const Py_ssize_t offset = offsets[i];
    int32_t first_word = -1;  // word-id re-base anchor for the window
    const Py_ssize_t n_words = PySequence_Size(sample);
    if (n_words < 0) {  // __len__ raised: propagate, don't return with
      release();        // a live pending exception (SystemError)
      return nullptr;
    }
    for (Py_ssize_t w = 0; w < n_words && pos < max_len; ++w) {
      PyObject* word = PySequence_GetItem(sample, w);
      if (word == nullptr || !PyUnicode_Check(word)) {
        Py_XDECREF(word);
        release();
        PyErr_SetString(PyExc_TypeError, "words must be str");
        return nullptr;
      }
      if (PyUnicode_READY(word) != 0) {
        Py_DECREF(word);
        release();
        return nullptr;
      }
      const Py_ssize_t n_chars = PyUnicode_GET_LENGTH(word);
      const int kind = PyUnicode_KIND(word);
      const void* data = PyUnicode_DATA(word);
      if (stream + n_chars + 1 <= offset) {
        stream += n_chars + 1;  // whole word before the window
        Py_DECREF(word);
        continue;
      }
      for (Py_ssize_t c = 0; c < n_chars && pos < max_len; ++c, ++stream) {
        if (stream < offset) continue;
        if (first_word < 0) first_word = static_cast<int32_t>(w);
        label_row[pos] = LookupId(PyUnicode_READ(kind, data, c));
        word_row[pos] = static_cast<int32_t>(w) - first_word;
        ++pos;
      }
      if (stream >= offset && pos < max_len) {
        label_row[pos] = g_separator_id;
        word_row[pos] = -1;
        ++pos;
      }
      ++stream;  // the separator slot
      Py_DECREF(word);
    }
    lens[i] = static_cast<int32_t>(pos);
  }
  release();
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"set_symbol_table", SetSymbolTable, METH_VARARGS,
     "Install the codepoint→id lookup table."},
    {"pack_batch", PackBatch, METH_VARARGS,
     "Pack a batch of per-word phoneme strings into id/word-id buffers."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_plbert_native",
    "Native host-side batch packing for pl_bert_tpu.", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__plbert_native() { return PyModule_Create(&kModule); }
